"""Alignment faults that ``correct`` must catch, each planted in a query's
hits. A fault takes the program's ``k + 1`` best hits (``alignments.Hit``,
in its order) and returns the ``k`` it would answer with; a sound answer is
``hits[:-1]``."""

from __future__ import annotations

import dataclasses
import itertools

from swbench.alignments import GAP, Hit, columns, rescore


def from_port(found) -> list[Hit]:
    """``topk_alignments``' ``[(record, Alignment)]`` as hits."""
    return [Hit(rec, a.score, a.query_start, a.query_end, a.db_start, a.db_end,
                a.query_aligned, a.db_aligned, a.cigar) for rec, a in found]


def cigar_of(query_aligned: str, record_aligned: str) -> str:
    ops = columns(query_aligned, record_aligned)
    return "".join(f"{len(list(run))}{op}" for op, run in itertools.groupby(ops))


def restrung(hit: Hit, query_aligned: str, record_aligned: str, **spans) -> Hit:
    """``hit`` with new strings, their CIGAR, and ``spans`` changed."""
    return dataclasses.replace(hit, query_aligned=query_aligned, record_aligned=record_aligned,
                               cigar=cigar_of(query_aligned, record_aligned), **spans)


def residue_changed(hits, table, gap_open, gap_extend):
    """A residue of the first hit's record string changed."""
    h = hits[0]
    c = next(i for i, a in enumerate(h.record_aligned) if a != GAP)
    letter = "W" if h.record_aligned[c] != "W" else "A"
    ra = h.record_aligned[:c] + letter + h.record_aligned[c + 1 :]
    return [dataclasses.replace(h, record_aligned=ra)] + hits[1:-1]


def _swap(s: str, c: int) -> str:
    return s[:c] + s[c + 1] + s[c] + s[c + 2 :]


def _moves(h: Hit):
    """``h`` with one gap column swapped with the residue column beside it."""
    qa, ra = h.query_aligned, h.record_aligned
    for c in range(len(qa) - 1):
        if GAP not in (ra[c], ra[c + 1]) and (qa[c] == GAP) != (qa[c + 1] == GAP):
            yield restrung(h, _swap(qa, c), ra)
        if GAP not in (qa[c], qa[c + 1]) and (ra[c] == GAP) != (ra[c + 1] == GAP):
            yield restrung(h, qa, _swap(ra, c))


def gap_moved(hits, table, gap_open, gap_extend):
    """One gap column of the first gapped hit moved by one column, where
    that changes the score: the strings and the CIGAR stay consistent."""
    out = list(hits[:-1])
    for k, h in enumerate(out):
        for moved in _moves(h):
            if rescore(moved, table, gap_open, gap_extend) != h.score:
                out[k] = moved
                return out
    raise AssertionError("no hit has a gap to move")


def end_trimmed(hits, table, gap_open, gap_extend):
    """The first hit's last column dropped, its spans' ends with it."""
    h = hits[0]
    qa, ra = h.query_aligned[:-1], h.record_aligned[:-1]
    trimmed = restrung(h, qa, ra, query_end=h.query_end - (h.query_aligned[-1] != GAP),
                       record_end=h.record_end - (h.record_aligned[-1] != GAP))
    return [trimmed] + hits[1:-1]


def start_shifted(hits, table, gap_open, gap_extend):
    """The first hit's record span moved by one, its strings kept."""
    h = hits[0]
    return [dataclasses.replace(h, record_start=h.record_start + 1,
                                record_end=h.record_end + 1)] + hits[1:-1]


def score_raised(hits, table, gap_open, gap_extend):
    return [dataclasses.replace(hits[0], score=hits[0].score + 1)] + hits[1:-1]


def other_records_alignment(hits, table, gap_open, gap_extend):
    """The first two hits' alignments swapped, their records kept."""
    a, b = hits[0], hits[1]
    return [dataclasses.replace(b, record=a.record), dataclasses.replace(a, record=b.record)] \
        + hits[2:-1]


def skipped_record(hits, table, gap_open, gap_extend):
    """The best hit left out and the next one taken in."""
    return hits[1:]


def out_of_order(hits, table, gap_open, gap_extend):
    return hits[:-1][::-1]


TAMPERS = [residue_changed, gap_moved, end_trimmed, start_shifted, score_raised,
           other_records_alignment, skipped_record, out_of_order]
