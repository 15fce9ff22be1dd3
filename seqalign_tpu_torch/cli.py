"""``smith_waterman``-compatible command-line tool on PyTorch + CUDA.

``python -m seqalign_tpu_torch.cli`` takes the flags of ``seqalign_tpu.cli``
for the single-query and the multi-query search and prints the same lines:
the "Query File=... and Database File=..." line, ``Entry #N:`` / ``score: S``
per entry (under a ``Query #k: name`` line per query of a multi-record
query file), and the trailing ``Total Time:`` / ``Total Entries:`` lines,
with the same messages and exit codes; ``--align`` prints the JAX CLI's
alignment blocks, ``--stream-chunk`` and ``--checkpoint`` its bounded-memory
and resumable scans, and ``--trace`` writes a ``torch.profiler`` trace.
``--hosts`` / ``--host-id`` / ``--coordinator`` make the process one host
of a multi-host search (``parallel.multihost``, merged over
``torch.distributed`` with gloo); host 0 prints the merged result.

``SEQALIGN_PLATFORM`` picks the device: ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import sys

from .host import ScoringModel, load_substitution_matrix, sw_default_scoring

USAGE = """usage: {prog} [OPTIONS] [seq1 seq2]
  Smith-Waterman optimal local alignment (maximises score).
  Takes a query FASTA and a database FASTA and scores the query against
  every database record. Can read gzip files, FASTA and FASTQ.

  OPTIONS:
    --file <file>        Sequence file reading with gzip support - read two
                         sequences at a time and align them
    --files <f1> <f2>    Read one sequence from each file to align at one time
    --stdin              Read from STDIN (same as '--file -')

    --match <score>      [default: {match}]
    --mismatch <score>   [default: {mismatch}]
    --gapopen <score>    [default: {gapopen}]
    --gapextend <score>  [default: {gapextend}]

    --substitution_matrix <file>  see details for formatting

    --minscore <score>   Only print entries scoring at least this
                         (documented but unimplemented in the reference)

    --printseq           Print sequences before local alignments
    --printmatrices      Print dynamic programming matrices
    --printfasta         Print fasta header lines
    --pretty             Print with a descriptor line
    --colour             Print with colour

  EXTENSIONS (seqalign_tpu_torch):
    --engine <name>      stream | pallas | wavefront | scan | oracle
                         [default: stream; pallas is stream, the CUDA
                         kernels; oracle the scalar NumPy oracle]
    --lanes <n>          lane-batch width override
    --no-sort            do not length-sort the database (assume pre-sorted)
    --topk <n>           print only the n best-scoring entries
    --all-queries        score EVERY query-file record (batched on-device;
                         on by default for multi-record query files)
    --first-query        strict reference behavior: score only the first
                         query record (src/alignment_cmdline.c:355-360)
    --align <k>          print gapped alignments + CIGAR for the k best hits
    --checkpoint <dir>   chunk-level resume state for huge scans
    --db-cache <path>    persistent encoded-database cache (.sqc): parse
                         the FASTA once, mmap thereafter ('auto' = sidecar
                         <db>.sqc; rebuilt when the FASTA changes)
    --stream-chunk <n>   bounded-memory mode: process n db records at a time
    --trace <dir>        write a torch.profiler trace of the search
    --json               print results as one JSON object
    --hosts <n>          multi-host run: total torch.distributed processes
                         (with --host-id and --coordinator; DB striped per
                         host, scores merged over gloo)
    --host-id <i>        this process's id (0-based)
    --coordinator <a:p>  torch.distributed coordinator address (host 0's)

  SEQALIGN_PLATFORM=cuda|cpu picks the device [default: cuda].

 DETAILS:
  * Gap (of length N) penalty is: (open+N*extend)
  * To do alignment without affine gap penalty, set '--gapopen 0'.
  * Scoring files should be matrices, with entries separated by a single
    character or whitespace, or a builtin name (BLOSUM45, BLOSUM62, PAM250).
"""


def _usage_exit(prog: str, scoring: ScoringModel, err: str | None) -> int:
    if err is not None:
        sys.stderr.write("Error: " + err + ("\n" if not err.endswith("\n") else ""))
    sys.stderr.write(
        USAGE.format(
            prog=prog,
            match=scoring.match,
            mismatch=scoring.mismatch,
            gapopen=scoring.gap_open,
            gapextend=scoring.gap_extend,
        )
    )
    return 1


def _parse_int(s: str):
    try:
        return int(s)
    except ValueError:
        return None


def _has_second_record(path: str) -> bool:
    from .host import read_fasta

    try:
        it = read_fasta(path)
        try:
            next(it)
            return next(it, None) is not None
        finally:
            it.close()  # release the file handle from the probe
    except (OSError, ValueError, StopIteration):
        return False


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "smith_waterman"
    args = argv[1:]
    scoring = sw_default_scoring()

    if not args:
        return _usage_exit(prog, scoring, None)
    for a in args:
        if a.lower() in ("--help", "-help", "-h"):
            return _usage_exit(prog, scoring, None)

    file1 = file2 = None
    substitutions_set = match_set = False
    print_seq = print_fasta = False
    engine = None
    lanes = None
    sort = True
    topk = None
    minscore = None
    as_json = False
    first_query = False
    all_queries = False
    matrix_spec = None
    db_cache = None
    checkpoint = None
    stream_chunk = None
    trace_dir = None
    align_k = None
    hosts = None
    host_id = None
    coordinator = None

    i = 0
    n = len(args)
    while i < n:
        a = args[i]
        al = a.lower()
        if a.startswith("-"):
            if al == "--printseq":
                print_seq = True
            elif al == "--printmatrices":
                pass  # parsed but inert, like the reference (sw_cmdline.c:40-42)
            elif al == "--printfasta":
                print_fasta = True
            elif al == "--pretty" or al == "--colour":
                pass  # parsed but inert, like the reference
            elif al == "--stdin":
                file1, file2 = "", None
            elif al == "--no-sort":
                sort = False
            elif al == "--all-queries":
                all_queries = True
            elif al == "--first-query":
                first_query = True
            elif al == "--json":
                as_json = True
            elif i == n - 1:
                return _usage_exit(
                    prog, scoring, f"Unknown argument without parameter: {a}"
                )
            elif al == "--scoring":
                # Vestigial flag: the reference swallows --scoring plus its
                # argument with no effect (alignment_cmdline.c:226-228).
                i += 1
            elif al == "--substitution_matrix":
                matrix_spec = args[i + 1]
                substitutions_set = True
                i += 1
            elif al in ("--match", "--mismatch", "--gapopen", "--gapextend"):
                v = _parse_int(args[i + 1])
                if v is None:
                    return _usage_exit(
                        prog,
                        scoring,
                        f"Invalid {al} argument ('{args[i+1]}') must be an int",
                    )
                if al == "--match":
                    scoring.match = v
                    match_set = True
                elif al == "--mismatch":
                    scoring.mismatch = v
                elif al == "--gapopen":
                    scoring.gap_open = v
                else:
                    scoring.gap_extend = v
                i += 1
            elif al == "--file":
                file1, file2 = args[i + 1], None
                i += 1
            elif al == "--engine":
                engine = args[i + 1]
                i += 1
            elif al in ("--lanes", "--topk"):
                v = _parse_int(args[i + 1])
                if v is None or v <= 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid {al} argument ('{args[i+1]}') "
                        "must be a positive int",
                    )
                if al == "--lanes":
                    lanes = v
                else:
                    topk = v
                i += 1
            elif al == "--minscore":
                minscore = _parse_int(args[i + 1])
                if minscore is None:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --minscore argument ('{args[i+1]}') must be an int",
                    )
                i += 1
            elif al == "--db-cache":
                db_cache = args[i + 1]
                i += 1
            elif al == "--checkpoint":
                checkpoint = args[i + 1]
                i += 1
            elif al == "--stream-chunk":
                stream_chunk = _parse_int(args[i + 1])
                if stream_chunk is None or stream_chunk <= 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --stream-chunk argument ('{args[i+1]}') "
                        "must be a positive int",
                    )
                i += 1
            elif al == "--trace":
                trace_dir = args[i + 1]
                i += 1
            elif al == "--hosts":
                hosts = _parse_int(args[i + 1])
                if hosts is None or hosts <= 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --hosts argument ('{args[i+1]}') "
                        "must be a positive int",
                    )
                i += 1
            elif al == "--host-id":
                host_id = _parse_int(args[i + 1])
                if host_id is None or host_id < 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --host-id argument ('{args[i+1]}') "
                        "must be a nonnegative int",
                    )
                i += 1
            elif al == "--coordinator":
                coordinator = args[i + 1]
                i += 1
            elif al == "--align":
                align_k = _parse_int(args[i + 1])
                if align_k is None:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --align argument ('{args[i+1]}') must be an int",
                    )
                i += 1
            elif al == "--files":
                if i >= n - 2:
                    return _usage_exit(prog, scoring, "--files option takes 2 arguments")
                print(f"Query File={args[i+1]} and Database File={args[i+2]}")
                if args[i + 1] == "-" and args[i + 2] == "-":
                    file1, file2 = args[i + 1], None
                else:
                    file1, file2 = args[i + 1], args[i + 2]
                i += 2
            else:
                return _usage_exit(prog, scoring, f"Unknown argument '{a}'")
        else:
            if n - i != 2:
                return _usage_exit(prog, scoring, f"Unknown options: '{a}'")
            break
        i += 1

    if matrix_spec is not None:
        try:
            load_substitution_matrix(matrix_spec, scoring)
        except OSError:
            return _usage_exit(prog, scoring, f"Couldn't read: {matrix_spec}")

    if substitutions_set and not match_set:
        scoring.use_match_mismatch = False
    scoring.finalize()

    if scoring.use_match_mismatch and scoring.match < scoring.mismatch:
        return _usage_exit(
            prog, scoring, "Match value should not be less than mismatch penalty"
        )
    if file1 is None or file2 is None:
        if file1 is not None and file2 is None and file1 == "":
            sys.stderr.write(
                "Error: Both query and database files must be provided\n"
            )
            return 0  # reference main returns EXIT_SUCCESS here
        return _usage_exit(prog, scoring, "No input specified")

    if hosts is not None and hosts > 1:
        if host_id is None or coordinator is None:
            return _usage_exit(
                prog, scoring,
                "--hosts requires --host-id and --coordinator",
            )
        return _run_multihost(
            file1, file2, scoring, topk, minscore, as_json,
            hosts, host_id, coordinator, db_cache=db_cache,
        )

    # A multi-record query file batches every record through the
    # multi-query kernel (the reference reads only the first record,
    # src/alignment_cmdline.c:355-360); --first-query, and the modes tied to
    # single-query semantics, keep first-record behaviour.
    single_only = (
        align_k is not None or stream_chunk is not None
        or checkpoint is not None or print_seq or trace_dir is not None
    )
    if (
        not all_queries and not first_query and not single_only
        and file1 != "-" and _has_second_record(file1)
    ):
        all_queries = True

    from .pipeline import ENGINES, resolve_device, search_files

    if engine is not None and engine not in ENGINES:
        return _usage_exit(
            prog, scoring,
            f"Unknown engine '{engine}': expected one of {', '.join(ENGINES)}",
        )
    try:
        device = resolve_device()
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"Error: {e}\n")
        return 1

    if all_queries:
        return _run_multi(
            file1, file2, scoring, engine, lanes, topk, as_json, print_fasta,
            minscore=minscore, db_cache=db_cache,
        )
    if align_k is not None:
        return _run_align(
            file1, file2, scoring, engine, lanes, align_k, as_json,
            db_cache=db_cache,
        )

    if db_cache is not None and print_seq:
        # --printseq needs the original sequence strings, which the
        # encoded cache does not keep.
        sys.stderr.write(
            "Note: --db-cache is ignored with --printseq (it needs the "
            "FASTA's original sequence text).\n"
        )
        db_cache = None

    trace = _start_trace(device) if trace_dir is not None else None
    try:
        if stream_chunk is not None:
            from .pipeline import search_files_streaming

            result = search_files_streaming(
                file1, file2, scoring, engine=engine, lanes=lanes,
                chunk_records=stream_chunk, checkpoint_dir=checkpoint,
                db_cache=db_cache,
            )
        else:
            result = search_files(
                file1, file2, scoring, engine=engine, lanes=lanes,
                keep_seqs=print_seq, db_cache=db_cache, sort=sort,
                checkpoint_dir=checkpoint,
            )
    except NotImplementedError as e:
        sys.stderr.write(f"Error: {e}\n")
        return 1
    except ValueError as e:
        sys.stderr.write(str(e) + "\n")
        return 0  # reference prints the error and exits successfully
    finally:
        if trace is not None:
            _stop_trace(trace, trace_dir)

    out = sys.stdout
    order = range(result.total_entries)
    if topk is not None:
        import numpy as np

        order = list(np.argsort(-result.scores, kind="stable")[:topk])
    if minscore is not None:
        order = [k for k in order if result.scores[k] >= minscore]

    if as_json:
        import json

        json.dump(
            {
                "query": result.query_name,
                "entries": [
                    {
                        "entry": int(k),
                        "name": result.names[k],
                        "score": int(result.scores[k]),
                    }
                    for k in order
                ],
                "total_time": result.kernel_time,
                "total_entries": result.total_entries,
                "entries_per_s": (
                    result.total_entries / result.kernel_time
                    if result.kernel_time
                    else None
                ),
            },
            out,
        )
        out.write("\n")
        return 0

    if print_fasta:
        out.write(result.query_name + "\n")
    if print_seq:
        out.write(result.query_seq + "\n")
    for k in order:
        out.write(f"Entry #{k}:\n")
        if print_fasta:
            out.write(result.names[k] + "\n")
        if print_seq:
            out.write(result.seqs[k] + "\n")
        out.write(f"score: {int(result.scores[k])}\n\n")

    out.write(f"Total Time: {result.kernel_time:f}\n")
    out.write(f"Total Entries: {result.total_entries}\n")
    return 0


def _start_trace(device):
    """A started ``torch.profiler`` over the host and, on a GPU, the card,
    or None when the profiler cannot start (tracing is best-effort
    observability, as ``jax.profiler`` is in the JAX CLI)."""
    try:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof
    except Exception as e:
        sys.stderr.write(f"Note: profiler unavailable ({e})\n")
        return None


def _stop_trace(prof, trace_dir: str) -> None:
    """Stop ``prof`` and write its Chrome trace into ``trace_dir``."""
    import os

    try:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"seqalign_trace_{os.getpid()}.json")
        )
    except Exception as e:
        sys.stderr.write(f"Note: profiler unavailable ({e})\n")


def _run_align(
    file1, file2, scoring, engine, lanes, k, as_json, db_cache=None
) -> int:
    """--align mode: score-only scan, then re-align the k best hits with a
    full traceback (``ops.traceback.topk_alignments``)."""
    from .host import parse_file_cached, read_first
    from .ops.traceback import topk_alignments
    from .pipeline import _warn_padding, search_database

    try:
        query = read_first(file1)
        query_idx = scoring.query_indices(query.seq)
        _warn_padding(scoring, query_idx)
        db = parse_file_cached(file2, db_cache)
        scores, kernel_time = search_database(
            query_idx, db, scoring, engine=engine, lanes=lanes
        )
    except (ValueError, OSError) as e:
        sys.stderr.write(str(e) + "\n")
        return 0

    hits = topk_alignments(
        query_idx, db, scores, k, scoring.table,
        scoring.gap_open, scoring.gap_extend, query_str=query.seq,
    )
    out = sys.stdout
    if as_json:
        import json

        json.dump(
            {
                "query": query.name,
                "alignments": [
                    {
                        "entry": rec,
                        "name": db.names[rec],
                        "score": aln.score,
                        "query_start": aln.query_start,
                        "query_end": aln.query_end,
                        "db_start": aln.db_start,
                        "db_end": aln.db_end,
                        "query_aligned": aln.query_aligned,
                        "db_aligned": aln.db_aligned,
                        "cigar": aln.cigar,
                    }
                    for rec, aln in hits
                ],
                "total_time": kernel_time,
                "total_entries": db.n,
            },
            out,
        )
        out.write("\n")
        return 0
    for rec, aln in hits:
        out.write(f"Entry #{rec}:\n")
        if db.names[rec]:
            out.write(db.names[rec] + "\n")
        out.write(f"score: {aln.score}\n")
        out.write(
            f"query {aln.query_start}..{aln.query_end}  "
            f"db {aln.db_start}..{aln.db_end}  CIGAR {aln.cigar}\n"
        )
        out.write(aln.query_aligned + "\n")
        out.write(aln.db_aligned + "\n\n")
    out.write(f"Total Time: {kernel_time:f}\n")
    out.write(f"Total Entries: {db.n}\n")
    return 0


def _run_multihost(
    file1, file2, scoring, topk, minscore, as_json, hosts, host_id,
    coordinator,
    db_cache=None,
) -> int:
    """--hosts mode: this process joins a multi-host search as one worker.

    Every host reads its database stripe, scores it on its local devices,
    and the merged global result (identical on every host) is printed by
    host 0 only. A failure (no GPU, a query over ``MAX_QUERY_ROWS``, a lost
    peer) prints ``Error: ...`` and exits 1.
    """
    from .host import read_first
    from .parallel.multihost import multihost_search

    try:
        query = read_first(file1)
        query_idx = scoring.query_indices(query.seq)
        scores, kernel_time = multihost_search(
            query_idx, file2, scoring,
            coordinator_address=coordinator, num_processes=hosts,
            process_id=host_id, db_cache=db_cache,
        )
    except (ValueError, RuntimeError) as e:
        sys.stderr.write(f"Error: {e}\n")
        return 1
    if host_id != 0:
        return 0
    out = sys.stdout
    order = range(len(scores))
    if topk is not None:
        import numpy as np

        order = list(np.argsort(-scores, kind="stable")[:topk])
    if minscore is not None:
        order = [k for k in order if scores[k] >= minscore]
    if as_json:
        import json

        json.dump(
            {
                "query": query.name,
                "hosts": hosts,
                "entries": [
                    {"entry": int(k), "score": int(scores[k])} for k in order
                ],
                "total_time": kernel_time,
                "total_entries": len(scores),
            },
            out,
        )
        out.write("\n")
        return 0
    for k in order:
        out.write(f"Entry #{k}:\n")
        out.write(f"score: {int(scores[k])}\n\n")
    out.write(f"Total Time: {kernel_time:f}\n")
    out.write(f"Total Entries: {len(scores)}\n")
    return 0


def _run_multi(
    file1, file2, scoring, engine, lanes, topk, as_json, print_fasta,
    minscore=None, db_cache=None,
) -> int:
    """--all-queries mode: one block of entries per query record."""
    from .pipeline import search_files_multi

    try:
        result = search_files_multi(
            file1, file2, scoring, engine=engine, lanes=lanes,
            db_cache=db_cache,
        )
    except NotImplementedError as e:
        sys.stderr.write(f"Error: {e}\n")
        return 1
    except ValueError as e:
        sys.stderr.write(str(e) + "\n")
        return 0

    out = sys.stdout
    nq = len(result.query_names)

    def order_for(qi):
        order = range(result.total_entries)
        if topk is not None:
            import numpy as np

            order = list(np.argsort(-result.scores[qi], kind="stable")[:topk])
        if minscore is not None:
            order = [k for k in order if result.scores[qi, k] >= minscore]
        return order

    if as_json:
        import json

        json.dump(
            {
                "queries": [
                    {
                        "query": result.query_names[qi],
                        "entries": [
                            {
                                "entry": int(k),
                                "name": result.names[k],
                                "score": int(result.scores[qi, k]),
                            }
                            for k in order_for(qi)
                        ],
                    }
                    for qi in range(nq)
                ],
                "total_time": result.kernel_time,
                "total_entries": result.total_entries,
            },
            out,
        )
        out.write("\n")
        return 0

    for qi in range(nq):
        out.write(f"Query #{qi}: {result.query_names[qi]}\n")
        for k in order_for(qi):
            out.write(f"Entry #{k}:\n")
            if print_fasta:
                out.write(result.names[k] + "\n")
            out.write(f"score: {int(result.scores[qi, k])}\n\n")

    out.write(f"Total Time: {result.kernel_time:f}\n")
    out.write(f"Total Entries: {result.total_entries}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
