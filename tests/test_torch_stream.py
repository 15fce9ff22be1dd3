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

    # K5's loop gathers nothing: its cells are the loop's unroll, rows x
    # positions per iteration; a shorter gatherless loop loses to one that
    # gathers where both exist.
    k5 = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_117sw_windows_kernelILb0ELb1EEEvPKi",
        "        /*0000*/                   S2R R0, SR_TID.X ;",
        "        /*0010*/                   VIADDMNMX R5, R5, R3, R4, !PT ;",
        "        /*0020*/                   VIADD R6, R5, 0x7 ;",
        "        /*0030*/                   VIMNMX3.RELU R6, R5, R4, R6 ;",
        "        /*0040*/               @P0 BRA 0x10 ;",
        "        /*0050*/                   EXIT ;",
    ])
    name = "_ZN12_GLOBAL__N_117sw_windows_kernelILb0ELb1EEEvPKi"
    loop = sass.inner_loop(sass.sass_functions(None, k5)[name])
    assert (loop["instructions"], loop["cells"]) == (4, sass.CELLS_PER_ITERATION)
    assert loop["cells_from"] == "CELLS_PER_ITERATION"
    assert loop["alu_per_cell"] == 3 / sass.CELLS_PER_ITERATION
    both = sass.sass_functions(None, text + "\n" + k5.split("\n", 1)[1].replace(
        "0x10", "0x100").replace("/*00", "/*01"))
    loop = sass.inner_loop(both["_ZN12_GLOBAL__N_116sw_stream_kernelEv"])
    assert (loop["instructions"], loop["cells"]) == (5, 2)
    assert sass.kernel_key(name) == "sw_windows_kernel<false, true>"
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
