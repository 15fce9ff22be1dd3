"""The port's stream kernel wrapper and its plain version against the JAX
package's ``sw_pallas_stream`` in interpret mode, slot by slot, on the same
``pack_streams`` output carried across by ``convert.py``."""

import numpy as np
import pytest
import torch

from seqalign_tpu.ops.swa_pallas import sw_pallas_stream
from seqalign_tpu.utils.packing import pack_streams
from seqalign_tpu_torch.convert import profile_to_torch, stream_pack_to_torch
from seqalign_tpu_torch.ops import _build
from seqalign_tpu_torch.ops.swa_cuda import (
    MAX_QUERY_ROWS, supported_scoring, sw_stream, sw_stream_multi,
    sw_stream_reference,
)
from seqalign_tpu_torch.ops.swa_torch import make_profile
from seqalign_tpu_torch.pipeline import _db_from_encoded

from _torch_cases import make_scoring, random_records
from conftest import random_protein

WIN, JB = 128, 4  # one 128-lane TPU window (sl=1), the smallest K1 shape


def _both(sc, q, encoded, nw, grain=8, order=None):
    """(JAX interpret output, port plain output, pack) for one stream pack."""
    db = _db_from_encoded(encoded)
    if order is None:
        order = np.argsort(-db.lengths, kind="stable")
    pack = pack_streams(db, order, nw, win=WIN, jb=JB, grain=grain)
    nslots = len(pack.slot_ids)
    prof = make_profile(sc.table, q)
    go, ge = sc.gap_open_total, sc.gap_extend
    want = np.asarray(
        sw_pallas_stream(
            prof, pack.streams, pack.fs, go, ge,
            nslots=nslots, sl=1, nw=nw, jb=JB, ui=4, interpret=True,
        )
    )
    streams, fs = stream_pack_to_torch(pack, "cpu")
    got = sw_stream_reference(
        profile_to_torch(prof, go, "cpu"), streams, fs, go, ge,
        nslots=nslots, jb=JB,
    )
    return want, got.numpy(), pack


@pytest.mark.parametrize(
    "scoring", ["BLOSUM62", "PAM250", "match_mismatch", "go_eq_ge"]
)
def test_reference_matches_pallas_stream(scoring):
    """Several segments per window: flush + reset between them."""
    sc = make_scoring(scoring)
    rng = np.random.default_rng(11)
    q = sc.query_indices(random_protein(rng, 10))
    want, got, pack = _both(sc, q, random_records(rng, 700, 1, 14), nw=2)
    assert len(pack.slot_ids) == 6 and (pack.fs[:, :, 0] > 0).sum() >= 2
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_tail_segment_on_last_block():
    """A segment starting at the final block: its start flush and the
    window's end flush fire in the same step."""
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(12)
    q = sc.query_indices(random_protein(rng, 8))
    encoded = random_records(rng, WIN, 20, 21) + random_records(rng, WIN, 3, 4)
    want, got, pack = _both(
        sc, q, encoded, nw=1, grain=JB, order=np.arange(len(encoded))
    )
    starts = np.nonzero(pack.fs[:, 0, 0])[0]
    assert len(starts) == 1 and starts[0] == pack.fs.shape[0] - 1
    np.testing.assert_array_equal(got, want)


def test_window_without_segment():
    """More windows than segments: one stream holds only padding and is
    never flushed."""
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(13)
    q = sc.query_indices(random_protein(rng, 7))
    want, got, pack = _both(sc, q, random_records(rng, 200, 1, 12), nw=3)
    assert len(pack.slot_ids) == 2 and not pack.fs[:, 2].any()
    np.testing.assert_array_equal(got, want)


def test_public_wrapper_on_cpu_is_the_plain_version():
    sc = make_scoring("BLOSUM45")
    rng = np.random.default_rng(14)
    q = sc.query_indices(random_protein(rng, 5))
    db = _db_from_encoded(random_records(rng, 300, 1, 10))
    pack = pack_streams(db, np.argsort(-db.lengths, kind="stable"), 2,
                        win=WIN, jb=JB, grain=8)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(make_profile(sc.table, q), go, "cpu")
    streams, fs = stream_pack_to_torch(pack, "cpu")
    kw = dict(nslots=len(pack.slot_ids), jb=JB)
    launches, calls = sw_stream.launches, sw_stream_reference.calls
    got = sw_stream(prof, streams, fs, go, ge, **kw)
    assert sw_stream.launches == launches  # no kernel on a CPU tensor
    assert sw_stream_reference.calls == calls + 1
    assert torch.equal(got, sw_stream_reference(prof, streams, fs, go, ge, **kw))


def test_convert_shapes_and_bias():
    sc = make_scoring("BLOSUM62")
    prof = make_profile(sc.table, sc.query_indices("MKVLA"))
    go = sc.gap_open_total
    t = profile_to_torch(prof, go, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (8, 32)
    np.testing.assert_array_equal(t[:5].numpy(), prof - go)
    assert not t[5:].any()


def _small_inputs(rows=4, nw=1, length=8):
    prof = torch.zeros((rows, 32), dtype=torch.int32)
    streams = torch.full((nw, length, WIN), 31, dtype=torch.int8)
    fs = torch.zeros((length // JB, nw, 2), dtype=torch.int32)
    return prof, streams, fs


def test_three_d_profile_names_k3():
    """A 3-D (multi-query) profile is carried across and scored by the K3
    wrapper; the K1 wrapper points it there."""
    prof, streams, fs = _small_inputs()
    fs[-1, 0, 1] = 1
    with pytest.raises(ValueError, match="K3"):
        sw_stream(prof[None], streams, fs, -3, -1, nslots=1, jb=JB)
    prof3 = profile_to_torch(np.zeros((2, 3, 32), np.int32), -3, "cpu")
    assert tuple(prof3.shape) == (2, 4, 32)
    got = sw_stream_multi(prof3, streams, fs, -3, -1, nslots=1, jb=JB)
    assert got.shape == (1, 2, WIN) and got.dtype == torch.int32
    # P = 0 rows against '*' padding: every score is 0.
    assert not got.any()


def test_query_above_row_limit_names_k2():
    prof, streams, fs = _small_inputs(rows=MAX_QUERY_ROWS + 4)
    with pytest.raises(NotImplementedError, match="K2"):
        sw_stream(prof, streams, fs, -3, -1, nslots=1, jb=JB)


@pytest.mark.parametrize(
    "bad", ["ge_lt_go", "jb", "fs_shape", "dtype", "slot_range"]
)
def test_wrapper_rejects_malformed_input(bad):
    prof, streams, fs = _small_inputs()
    go, ge, jb, nslots = -3, -1, JB, 1
    if bad == "ge_lt_go":
        go, ge = 1, -1
    elif bad == "jb":
        jb = 0
    elif bad == "fs_shape":
        fs = fs[:1]
    elif bad == "dtype":
        streams = streams.to(torch.int32)
    else:
        fs[-1, 0, 1] = 2
    with pytest.raises(ValueError):
        sw_stream(prof, streams, fs, go, ge, nslots=nslots, jb=jb)


def test_supported_scoring_envelope():
    sc = make_scoring("BLOSUM62")
    prof = make_profile(sc.table, sc.query_indices("MKVLAW"))
    assert supported_scoring(prof, -3, -1)
    assert supported_scoring(prof, -2, -2)  # go == ge
    assert not supported_scoring(prof, 1, -1)  # ge < go (--gapopen 2)
    assert not supported_scoring(prof, -3, 1)  # positive extend
    # int32 overflow: Lq * max(P) past 2**31.
    big = np.full((2**16, 32), 2**16, dtype=np.int32)
    assert not supported_scoring(big, -3, -1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(tmp_path / "build")


def test_sass_inner_loop_counts_cells():
    """The bound's instruction count: the shortest backward branch holding
    DP work is the row loop, one LDS (the profile gather) per cell."""
    from seqalign_tpu_torch import sass

    text = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_116sw_stream_kernelEv",
        "        /*0000*/                   S2R R0, SR_TID.X ;",
        "        /*0010*/                   LDG.E R2, desc[UR4][R8.64] ;",
        "        /*0020*/                   LDS R4, [R3] ;",
        "        /*0030*/                   VIADDMNMX R5, R5, R3, R4, !PT ;",
        "        /*0040*/                   LDS R6, [R3+0x80] ;",
        "        /*0050*/                   VIMNMX3.RELU R6, R5, R4, R6 ;",
        "        /*0060*/               @P0 BRA 0x20 ;",
        "        /*0070*/               @P1 BRA 0x10 ;",
        "        /*0080*/                   EXIT ;",
    ])
    funcs = sass.sass_functions(None, text)
    loop = sass.inner_loop(funcs["_ZN12_GLOBAL__N_116sw_stream_kernelEv"])
    assert (loop["instructions"], loop["cells"]) == (5, 2)
    assert loop["alu_per_cell"] == 1.0  # VIADDMNMX and VIMNMX3 over 2 cells
    assert loop["cells_from"] == "LDS"

    # K5's loop gathers nothing: its cells are its instance's step, 2 R
    # (R = 20 here), which the loop cannot tell without the instance's key;
    # a shorter gatherless loop loses to one that gathers where both exist.
    k5 = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_117sw_windows_kernelILi20ELb0ELb1EEEvPKiPKaPiiiiiiiii",
        "        /*0000*/                   S2R R0, SR_TID.X ;",
        "        /*0010*/                   VIADDMNMX R5, R5, R3, R4, !PT ;",
        "        /*0020*/                   VIADD R6, R5, 0x7 ;",
        "        /*0030*/                   VIMNMX3.RELU R6, R5, R4, R6 ;",
        "        /*0040*/               @P0 BRA 0x10 ;",
        "        /*0050*/                   EXIT ;",
    ])
    name = "_ZN12_GLOBAL__N_117sw_windows_kernelILi20ELb0ELb1EEEvPKiPKaPiiiiiiiii"
    key = sass.kernel_key(name)
    loop = sass.inner_loop(sass.sass_functions(None, k5)[name], key)
    assert (loop["instructions"], loop["cells"]) == (4, 40)
    assert loop["cells_from"] == "step"
    assert loop["alu_per_cell"] == 3 / 40
    with pytest.raises(ValueError, match="instance key"):
        sass.inner_loop(sass.sass_functions(None, k5)[name])
    both = sass.sass_functions(None, text + "\n" + k5.split("\n", 1)[1].replace(
        "0x10", "0x100").replace("/*00", "/*01"))
    loop = sass.inner_loop(both["_ZN12_GLOBAL__N_116sw_stream_kernelEv"])
    assert (loop["instructions"], loop["cells"]) == (5, 2)
    assert sass.kernel_key(name) == "sw_windows_kernel<20, false, true>"
    assert sass.kernel_key("_ZN12_GLOBAL__N_116sw_stream_kernelEv") == "sw_stream_kernel"
    assert sass.kernel_key("_Z3foov") is None


@pytest.mark.parametrize("fails", [None, "sw_striped.cu"])
def test_build_compiles_each_source_then_links(fails, monkeypatch, tmp_path):
    """Every csrc/*.cu compiles on its own (nvcc -c, all started before any
    is waited for), then one nvcc links the objects; a failed compile
    raises with its output, and no object is left behind."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$*" >> {log}\n'
        f'case "$*" in *{fails or "@none@"}*) echo "bad source" >&2; exit 3;; esac\n'
        'while [ "$#" -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    out = tmp_path / "build"
    srcs = sorted(p.name for p in _build._CSRC.glob("*.cu"))
    assert "sw_striped.cu" in srcs and "sw_stream.cu" in srcs
    if fails:
        with pytest.raises(RuntimeError, match="bad source"):
            _build.build(out)
        assert not list(out.glob("*.so"))
    else:
        lib = _build.build(out)
        assert lib.exists() and lib.suffix == ".so"
        calls = log.read_text().splitlines()
        compiles = [c for c in calls if " -c " in f" {c} "]
        assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == srcs
        assert all("-shared" not in c.split() for c in compiles)
        link = calls[-1].split()
        assert "-shared" in link and sum(a.endswith(".o") for a in link) == len(srcs)
    assert not list(out.glob("*.o"))


# The one-pass team kernel of K1 and K3 (csrc/sw_stream.cu): its host side.

_LQP_BLOCKS = [(0, 52), (52, 200), (200, 400), (400, 800), (800, 1200), (1200, 1540)]


@pytest.mark.parametrize("lo,hi", _LQP_BLOCKS)
def test_stream_team_holds_every_query_length(lo, hi):
    """For every row count up to MAX_QUERY_ROWS (the one-pass kernel needs
    no ROW_ALIGN multiple) the chooser names a built (T, R) whose team holds
    the rows, padding them by at most 1/6 or 3 rows, or to the smallest R
    built."""
    from seqalign_tpu_torch.ops import swa_cuda

    for lqp in range(lo, min(hi, swa_cuda.MAX_QUERY_ROWS + 1)):
        t, r = swa_cuda.stream_team(lqp)
        assert t in swa_cuda.STREAM_TEAMS and r in swa_cuda.STREAM_ROWS_PER_THREAD_BUILT
        assert lqp <= t * r <= max(lqp * 7 // 6, lqp + 3, min(swa_cuda.STREAM_ROWS_PER_THREAD_BUILT))
        want = (f"sw_stream_solo_kernel<{r}, 1>" if t == 1 and r in swa_cuda.STREAM_SOLO_ROWS
                else f"sw_stream_kernel<{r}, false>")
        assert swa_cuda.stream_kernel_instance(lqp) == want


@pytest.mark.parametrize("lqp,team", [
    (0, (1, 10)), (20, (1, 20)), (144, (4, 36)), (512, (16, 32)), (1000, (32, 32)),
    (1536, (32, 48)),
])
def test_stream_team_choices(lqp, team):
    """The fewest padded rows, then the smallest team: lq=17 (20 rows) runs
    one thread per lane, lq=144 four threads of 36 rows."""
    from seqalign_tpu_torch.ops import swa_cuda

    assert swa_cuda.stream_team(lqp) == team


def test_stream_team_refuses_more_rows_than_a_warp_holds():
    from seqalign_tpu_torch.ops import swa_cuda

    with pytest.raises(ValueError, match="1540 rows"):
        swa_cuda.stream_team(1540)


def test_stream_rows_built_match_the_source():
    """The R the chooser may name are the instances the C entry builds, the
    solo (R, Q) those sw_stream_solo.cu builds; the widest team of the
    largest R holds MAX_QUERY_ROWS, and its profile (4 KiB x R) fits a
    Hopper block's 227 KiB of shared memory."""
    import re
    from pathlib import Path

    from seqalign_tpu_torch.ops import swa_cuda

    csrc = Path(swa_cuda.__file__).resolve().parent.parent / "csrc"
    built = tuple(int(r) for r in re.findall(
        r"SW_STREAM_ROWS\((\d+)\)\n", (csrc / "sw_stream.cu").read_text()))
    pairs = [(int(r), int(q)) for r, q in re.findall(
        r"  X\((\d+), (\d+)\)", (csrc / "sw_stream_solo.cu").read_text())]
    solo = tuple(dict.fromkeys(r for r, _ in pairs))
    assert built == swa_cuda.STREAM_ROWS_PER_THREAD_BUILT
    assert solo == swa_cuda.STREAM_SOLO_ROWS and set(solo) <= set(built)
    assert pairs == [(r, q) for r, qs in swa_cuda.STREAM_SOLO_QUERIES.items() for q in qs]
    assert swa_cuda.STREAM_TEAMS == tuple(2**k for k in range(6))
    assert swa_cuda.MAX_QUERY_ROWS == swa_cuda.STREAM_TEAMS[-1] * max(built)
    assert 4096 * max(built) <= 232_448


@pytest.mark.parametrize("rows,team,nq,queries,key", [
    (144, None, 1, None, "sw_stream_kernel<36, false>"),
    (20, None, 1, None, "sw_stream_solo_kernel<20, 1>"),
    (17, None, 1, None, "sw_stream_solo_kernel<18, 1>"),
    (144, (8, 18), 1, None, "sw_stream_kernel<18, false>"),
    (40, None, 1, None, "sw_stream_kernel<40, false>"),
    (1536, None, 1, None, "sw_stream_kernel<48, false>"),
    (17, None, 8, 2, "sw_stream_solo_kernel<18, 2>"),
    (17, (1, 24), 64, 4, "sw_stream_solo_kernel<24, 4>"),
    (26, None, 8, None, "sw_stream_kernel<28, false>"),
    (17, (2, 10), 8, None, "sw_stream_kernel<10, false>"),
])
def test_stream_kernel_instance(rows, team, nq, queries, key):
    """The instance a K1 or K3 launch runs, keyed as sass.kernel_key keys it:
    the solo kernel for a team of one thread at a solo R (a team of one
    thread at a larger R runs the team kernel), the team kernel else."""
    from seqalign_tpu_torch.ops import swa_cuda

    assert swa_cuda.stream_kernel_instance(rows, team, nq, queries) == key
    if queries is None and key.startswith("sw_stream_solo_kernel<"):
        q = swa_cuda.stream_solo_queries(rows, nq)
        assert key.endswith(f", {q}>")


def _team_case(rows=144, nq=None):
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(15)
    db = _db_from_encoded(random_records(rng, 300, 1, 10))
    pack = pack_streams(db, np.argsort(-db.lengths, kind="stable"), 2, win=WIN, jb=JB, grain=8)
    go, ge = sc.gap_open_total, sc.gap_extend
    qs = [sc.query_indices(random_protein(rng, rows - 2)) for _ in range(nq or 1)]
    if nq:
        from seqalign_tpu_torch.pipeline import multi_profile

        prof = profile_to_torch(multi_profile(sc.table, qs), go, "cpu")
    else:
        prof = profile_to_torch(make_profile(sc.table, qs[0]), go, "cpu")
    streams, fs = stream_pack_to_torch(pack, "cpu")
    return prof, streams, fs, go, ge, dict(nslots=len(pack.slot_ids), jb=JB)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("team", [(3, 48), (4, 13), (1, 20), (64, 24), (2, 36)])
def test_stream_refuses_a_team_not_built_or_too_small(team, multi):
    """A forced (T, R) must be a built instance whose team holds the rows
    (144 here), on any device."""
    prof, streams, fs, go, ge, kw = _team_case(nq=2 if multi else None)
    fn = sw_stream_multi if multi else sw_stream
    with pytest.raises(ValueError, match="team="):
        fn(prof, streams, fs, go, ge, team=team, **kw)


@pytest.mark.parametrize("multi", [False, True])
def test_stream_forced_team_on_cpu_is_the_plain_version(multi):
    from seqalign_tpu_torch.ops.swa_cuda import sw_stream_multi_reference

    prof, streams, fs, go, ge, kw = _team_case(nq=3 if multi else None)
    fn, ref = (sw_stream_multi, sw_stream_multi_reference) if multi else (
        sw_stream, sw_stream_reference)
    got = fn(prof, streams, fs, go, ge, team=(8, 18), **kw)
    assert torch.equal(got, ref(prof, streams, fs, go, ge, **kw))


@pytest.mark.parametrize("multi", [False, True])
def test_stream_refuses_slots_the_segment_word_cannot_hold(multi):
    """K1 and K3 share K2's segment word (csrc/sw_team.cuh): nslots from
    TEAM_MAX_SLOTS on are refused, on any device."""
    from seqalign_tpu_torch.ops import swa_cuda

    prof, streams, fs, go, ge, kw = _team_case(rows=8, nq=2 if multi else None)
    fn = sw_stream_multi if multi else sw_stream
    for nslots in (swa_cuda.TEAM_MAX_SLOTS, swa_cuda.TEAM_MAX_SLOTS + 1):
        with pytest.raises(ValueError, match="segment word"):
            fn(prof, streams, fs, go, ge, nslots=nslots, jb=JB)


@pytest.mark.parametrize("r,solo", [(10, 1), (20, 1), (20, 0), (36, 0), (48, 0)])
def test_sass_keys_and_cells_of_the_stream_kernel(r, solo):
    """K1 and K3's instances are keyed by R and kSolo (the team kernel) or
    by R and Q (the solo kernel, here at Q = 1); a step holds 2 R cells a
    query (one LDS each), as K2's does, and the solo kernel's loop runs two
    steps at Q = 1."""
    from seqalign_tpu_torch import sass

    name = (f"_ZN12_GLOBAL__N_121sw_stream_solo_kernelILi{r}ELi1EEEvPKiPKaS3_Piiiiiiiiii"
            if solo else
            f"_ZN12_GLOBAL__N_116sw_stream_kernelILi{r}ELb0EEEvPKiPKaS3_Piiiiiiiiii")
    key = sass.kernel_key(name)
    assert key == (f"sw_stream_solo_kernel<{r}, 1>" if solo else f"sw_stream_kernel<{r}, false>")
    steps = sass.solo_stream_steps(1) if solo else 1
    assert sass.expected_cells(key) == 2 * r * steps == r * sass.STRIPED_POSITIONS_PER_STEP * steps
    assert steps == (2 if solo else 1)
    # K4's instance of the same R and kSolo: a solo one unrolls the four
    # steps of its block into one loop iteration.
    windows = f"sw_windows_kernel<{r}, {'true' if solo else 'false'}, false>"
    assert sass.expected_cells(windows) == 2 * r * (sass.SOLO_WINDOWS_STEPS if solo else 1)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("rows,ok", [(None, True), (0, True), (5, True), (8, True),
                                     (9, False), (-1, False)])
def test_stream_rows_to_score(rows, ok, multi):
    """``rows`` names the profile's rows K1 and K3 score (the rest is the
    caller's padding, which the kernel skips); at most the profile's rows.
    The plain version scores every row, so on the CPU the result is the
    whole profile's."""
    from seqalign_tpu_torch.ops.swa_cuda import sw_stream_multi_reference

    prof, streams, fs, go, ge, kw = _team_case(rows=7, nq=2 if multi else None)
    assert prof.shape[-2] == 8
    fn, ref = (sw_stream_multi, sw_stream_multi_reference) if multi else (
        sw_stream, sw_stream_reference)
    if not ok:
        with pytest.raises(ValueError, match="rows="):
            fn(prof, streams, fs, go, ge, rows=rows, **kw)
        return
    got = fn(prof, streams, fs, go, ge, rows=rows, **kw)
    assert torch.equal(got, ref(prof, streams, fs, go, ge, **kw))


# The solo kernel of K1 and K3 (csrc/sw_stream_solo.cu): one thread a lane
# scoring Q queries of the launch.

@pytest.mark.parametrize("r", [10, 12, 16, 18, 20, 24])
@pytest.mark.parametrize("nq", [1, 2, 3, 5, 8, 9, 64])
def test_stream_solo_queries(nq, r):
    """Q is built at the chooser's R, 1 for one query, and never more than
    nq rounded up to a built Q."""
    from seqalign_tpu_torch.ops import swa_cuda

    assert swa_cuda.stream_team(r) == (1, r)
    q = swa_cuda.stream_solo_queries(r, nq)
    built = swa_cuda.STREAM_SOLO_QUERIES[r]
    assert q in built
    assert q <= min([b for b in built if b >= nq] or [max(built)])
    if nq == 1:
        assert q == 1
    assert swa_cuda.stream_kernel_instance(r, nq=nq) == f"sw_stream_solo_kernel<{r}, {q}>"


@pytest.mark.parametrize("r", [10, 12, 16, 18, 20, 24])
def test_stream_solo_queries_built_are_those_it_picks(r):
    """Every solo (R, Q) built is one the chooser picks for some nq, and it
    picks no other."""
    from seqalign_tpu_torch.ops import swa_cuda

    picked = {swa_cuda.stream_solo_queries(r, nq) for nq in range(1, 65)}
    assert picked == set(swa_cuda.STREAM_SOLO_QUERIES[r])
    assert max(picked) == swa_cuda.STREAM_SOLO_BEST_QUERIES[r]


def test_stream_solo_queries_refuses_a_team():
    from seqalign_tpu_torch.ops import swa_cuda

    with pytest.raises(ValueError, match="not a team of one thread"):
        swa_cuda.stream_solo_queries(144, 8)


@pytest.mark.parametrize("team,queries", [((2, 10), 2), ((1, 28), 1), ((4, 36), 4),
                                          ((1, 18), 3), ((1, 18), 8), (None, 0),
                                          ((1, 16), 2)])
def test_multi_refuses_queries_off_a_solo_team(team, queries):
    """A forced Q is taken only where (T, R) is solo and Q is built at R, on
    any device."""
    prof, streams, fs, go, ge, kw = _team_case(rows=17, nq=3)
    with pytest.raises(ValueError, match="queries="):
        sw_stream_multi(prof, streams, fs, go, ge, team=team, queries=queries, **kw)


@pytest.mark.parametrize("queries", [1, 2, 4])
def test_multi_forced_queries_on_cpu_is_the_plain_version(queries):
    """On a CPU tensor a forced Q runs the plain version (which has no Q)
    and launches nothing."""
    from seqalign_tpu_torch.ops.swa_cuda import sw_stream_multi_reference

    # Queries of 9 residues: (T, R) = (1, 10), where Q = 1, 2 and 4 are built.
    prof, streams, fs, go, ge, kw = _team_case(rows=11, nq=5)
    launches = sw_stream_multi.launches
    got = sw_stream_multi(prof, streams, fs, go, ge, rows=9, queries=queries, **kw)
    assert sw_stream_multi.launches == launches
    assert torch.equal(got, sw_stream_multi_reference(prof, streams, fs, go, ge, **kw))


def _solo_sass(r, q, lds_per_cell=1):
    """A synthetic solo-kernel function: a hot loop of 2 Q R cells (LDS,
    IMAD, two VIADDMNMX, VIMNMX3.RELU, IADD3 and a VIMNMX3 a cell), the
    loads of a step's chars ahead (two LDG, two LOP3 masks) and the loop
    test."""
    name = f"_ZN12_GLOBAL__N_121sw_stream_solo_kernelILi{r}ELi{q}EEEvPKiPKaS3_Piiiiiiiiii"
    body = ["LDG.E.U8 R8, desc[UR4][R10.64]", "LDG.E.U8 R9, desc[UR4][R12.64]",
            "LOP3.LUT R8, R8, 0x1f, RZ, 0xc0, !PT", "LOP3.LUT R9, R9, 0x1f, RZ, 0xc0, !PT"]
    for _ in range(2 * q * r):
        body += ["LDS R4, [R3+0x80]" if lds_per_cell else "NOP", "IMAD R5, R6, R7, R4",
                 "VIADDMNMX R5, R5, R3, R4, !PT", "VIADDMNMX R6, R2, R3, R4, !PT",
                 "VIMNMX3.RELU R6, R5, R4, R6", "IADD3 R7, R6, R2, RZ",
                 "VIMNMX3 R9, R9, R6, R7"]
    body += ["IADD3 R1, R1, 0x1, RZ", "ISETP.NE.AND P0, PT, R1, R2, PT"]
    lines = [f"\t\tFunction : {name}", "        /*0000*/                   S2R R0, SR_TID.X ;"]
    for k, ins in enumerate(body):
        lines.append(f"        /*{16 * (k + 1):04x}*/                   {ins} ;")
    lines.append(f"        /*{16 * (len(body) + 1):04x}*/               @P0 BRA 0x10 ;")
    lines.append(f"        /*{16 * (len(body) + 2):04x}*/                   EXIT ;")
    return name, "\n".join(lines), len(body) + 1


def test_sass_inner_loop_counts_cells_of_the_solo_kernel():
    """The bound's count for sw_stream_solo_kernel<18, 2>: its key names R
    and Q, its loop's cells are 2 Q R = 72 (one LDS each, the expected count
    from the key), and the step's own work (its chars' masks, the loop
    test) is spread over them."""
    from seqalign_tpu_torch import sass

    name, text, size = _solo_sass(18, 2)
    key = sass.kernel_key(name)
    assert key == "sw_stream_solo_kernel<18, 2>"
    loop = sass.inner_loop(sass.sass_functions(None, text)[name], key)
    assert loop["cells"] == sass.expected_cells(key) == 72 and loop["cells_from"] == "LDS"
    assert loop["instructions"] == size
    # Per cell 5 ALU instructions and an IMAD; a step adds two LOP3, an
    # IADD3 and an ISETP (the two LDG, the BRA are not ALU work).
    assert loop["alu_per_cell"] == (72 * 6 + 4) / 72
    assert loop["imad_per_cell"] == 1.0
    assert loop["pipe_per_cell"] == (72 * 5 + 4) / 72
    assert sass.expected_cells("sw_stream_solo_kernel<24, 4>") == 192
    # Q = 1: two steps (four positions) an iteration.
    assert sass.expected_cells("sw_stream_solo_kernel<10, 1>") == 40
