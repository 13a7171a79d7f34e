"""The probe kernels' plain versions and the port's measurement tools, on the
CPU, against the JAX package and tools/pallas_probe.py (tolerance 0).

The kernels themselves (csrc/probes.cu) run only on a card: their checks
against these plain versions are in tests/test_torch_cuda.py.
"""
import importlib.util
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevce_tpu.ops import quant as jquant
from hevce_tpu.ops import xform as jxform
from hevce_tpu.utils import imageio as jimageio
from hevce_tpu_torch.ops import constants as C
from hevce_tpu_torch.ops import fused_eval, probes
from hevce_tpu_torch.tools import bench_fused, cuda_probe, profile_front
from hevce_tpu_torch.utils import imageio, timing
from hevce_tpu_torch.utils.tracing import device_trace

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pallas_probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_probe", ROOT / "tools" / "pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------- P1

@pytest.mark.parametrize("n", [64, 1024])
def test_p1_plain_gives_n_after_n_steps(n):
    x = torch.zeros(cuda_probe.P1_SHAPE, dtype=torch.int32)
    for _ in range(n):
        assert probes.add_one(x) is x
    assert bool((x == n).all())
    assert probes.LAUNCHES["add_one"] == 0            # the CPU runs no kernel


# --------------------------------------------------------------------- P2

@pytest.mark.parametrize("case", ["random", "all -128"])
def test_p2_plain_equals_the_probes_reference(case):
    inputs = dict((c, (a, b)) for c, a, b in
                  cuda_probe.p2_inputs(np.random.default_rng(0)))
    a, b = inputs[case]
    assert a.shape == (512, 64) and b.shape == (64, 64)
    want = a.astype(np.int32) @ b.astype(np.int32)      # pallas_probe.py:86
    got = probes.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        probes.int8_mm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        want)


@pytest.mark.parametrize("M,K,N", [(77, 40, 36), (130, 33, 70), (5, 3, 1)])
def test_p2_plain_at_ragged_shapes(M, K, N):
    rng = np.random.default_rng(M * K * N)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    got = probes.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# --------------------------------------------------------------------- P3

@pytest.mark.parametrize("which", ["stage", "inv"])
def test_kron_matrices_equal_pallas_probe(which):
    ref = getattr(_pallas_probe(), f"_kron_{which}")(4)
    got = getattr(probes, f"kron_{which}")(4)
    for g, r in zip(got, ref):
        assert g.dtype == np.int8 and g.shape == (16, 16)
        np.testing.assert_array_equal(g, r)


def _digits(x, ndig):
    """base-128 digits of int64 x: low digits in [0, 127], the top signed."""
    return [(x >> (7 * k)) if k == ndig - 1 else (x >> (7 * k)) & 127
            for k in range(ndig)]


def _kernel_product(x, bt, ndig):
    """x (..., rows, k) @ bt^T (bt (n, k) int8) as csrc/mma_s8.cuh's users
    compute it: the depth zero-padded to a multiple of mma.sync's 16, int8
    digit products recombined by Horner's rule in an int32 accumulator."""
    pad = -x.shape[-1] % 16
    x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), np.int64)], -1)
    bt = np.pad(bt.astype(np.int64), ((0, 0), (0, pad)))
    acc = np.zeros(x.shape[:-1] + (bt.shape[0],), np.int64)
    for d in reversed(_digits(x, ndig)):
        assert d.min() >= -128 and d.max() <= 127        # each digit is s8
        acc = acc * 128 + d @ bt.T
        assert np.abs(acc).max() < 2**31                 # int32 accumulator
    return acc


def _rnd(x, s):
    return (x + (1 << s >> 1)) >> s


def _clip16(x):
    return np.clip(x, -32768, 32767)


def _extreme_blocks(rng, sz, n, lo, hi):
    """n blocks (n, sz, sz): the constant extremes, half and half,
    checkerboards, one-hot blocks, the sign pattern of a basis function at
    full scale (the largest first-stage sums), then uniform noise."""
    x = rng.integers(lo, hi + 1, (n, sz, sz))
    ii, jj = np.mgrid[0:sz, 0:sz]
    s1 = np.sign(C.TRANSFORM_MAT[sz][1]).astype(np.int64)
    s1[s1 == 0] = 1
    edges = [np.full((sz, sz), hi), np.full((sz, sz), lo),
             np.where(jj < sz // 2, lo, hi), np.where((ii + jj) % 2, lo, hi),
             np.where((ii + jj) % 2, hi, lo),
             np.where((ii == 0) & (jj == 0), hi, 0),
             np.where((ii == sz - 1) & (jj == 1), lo, 0),
             np.where(np.outer(s1, s1) > 0, hi, lo),
             np.where(np.outer(s1, s1) > 0, lo, hi)]
    x[:len(edges)] = edges
    return x


@pytest.mark.parametrize("sz", [4, 8, 16, 32])
def test_digit_split_kron_formulation_equals_direct_transform(sz):
    """The exact int8 tensor-core transforms in int64 numpy: P3's Kronecker
    form at 4x4 (csrc/probes.cu), K1's transposed-tile form at 8-32
    (csrc/fused_eval.cu: T^T = X^T @ M^T, C = T @ M^T, U^T = Dq^T @ M,
    R = U @ M, with the rows of M and M^T of fused_eval.stage_matrices as
    the B operand), equal to the JAX transforms at the extremes and on
    noise."""
    rng = np.random.default_rng(4 + sz)
    n = {4: 2000, 8: 600, 16: 200, 32: 60}[sz]
    resid = _extreme_blocks(rng, sz, n, -255, 255)
    dq = _extreme_blocks(rng, sz, n, -32768, 32767)
    a = int(C.FWD_SHIFT_A[sz])
    swap = lambda x: np.swapaxes(x, -1, -2)
    if sz == 4:
        k1, k2 = probes.kron_stage(4)
        ik1, ik2 = probes.kron_inv(4)
        flat = lambda x: x.reshape(n, 16)
        tmp = _rnd(_kernel_product(flat(resid), k1, 2), a)
        coef = _rnd(_kernel_product(tmp, k2, 3), a + 7).reshape(n, 4, 4)
        t1 = _clip16(_rnd(_kernel_product(flat(dq), ik1, 3), 7))
        rec = _clip16(_rnd(_kernel_product(t1, ik2, 3), 12)).reshape(n, 4, 4)
    else:
        mr, mt = fused_eval.stage_matrices(sz)
        np.testing.assert_array_equal(mr, C.TRANSFORM_MAT[sz])
        tmp = _rnd(swap(_kernel_product(swap(resid), mr, 2)), a)
        assert np.abs(tmp).max() < 2**17            # 3 digits hold it
        coef = _rnd(_kernel_product(tmp, mr, 3), a + 7)
        t1 = _clip16(_rnd(swap(_kernel_product(swap(dq), mt, 3)), 7))
        rec = _clip16(_rnd(_kernel_product(t1, mt, 3), 12))
    want = jxform.forward_transform(sz, jnp.asarray(resid.astype(np.int32)))
    np.testing.assert_array_equal(coef, np.asarray(want))
    want = jxform.inverse_transform(sz, jnp.asarray(dq.astype(np.int32)))
    np.testing.assert_array_equal(rec, np.asarray(want))
    if sz == 4:
        # the matrices act from the left on flattened blocks: x_row @ K^T.
        # The Pallas probe's mm(x, kron(eye, K)) takes x_row @ K, which is
        # M^T X: the transposed transform, so P3 follows the op chain instead
        m = C.TRANSFORM_MAT[4].astype(np.int64)
        np.testing.assert_array_equal(
            (resid.reshape(n, 16) @ k1.astype(np.int64).T).reshape(n, 4, 4),
            m @ resid)
        np.testing.assert_array_equal(
            (resid.reshape(n, 16) @ k1.astype(np.int64)).reshape(n, 4, 4),
            m.T @ resid)


@pytest.mark.parametrize("qpd6", [0, 2, 4])
def test_p3_plain_equals_jax_op_chain(qpd6):
    pred, blk = cuda_probe.p3_inputs(np.random.default_rng(qpd6), rows=64)
    q, sse = probes.fused4(torch.from_numpy(pred), torch.from_numpy(blk),
                           qpd6)
    # the probe's own op chain, tools/pallas_probe.py:279-288
    p4 = pred.reshape(64, 35, 4, 4)
    b4 = blk.reshape(64, 4, 4)
    resid = b4[:, None].astype(np.int16) - p4.astype(np.int16)
    coef = jxform.forward_transform(4, jnp.asarray(resid))
    q_want = np.asarray(jquant.quantize(4, qpd6, coef)).reshape(64, 560)
    dq = jquant.dequantize(4, qpd6, jnp.asarray(q_want.reshape(64, 35, 4, 4)))
    rinv = jxform.inverse_transform(4, dq)
    recon = np.clip(np.asarray(rinv).astype(np.int64) + p4, 0, 255)
    sse_want = ((b4[:, None].astype(np.int64) - recon) ** 2).sum((-1, -2))
    assert q.dtype == torch.int32 and sse.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), q_want)
    np.testing.assert_array_equal(sse.numpy(), sse_want)
    assert (q_want == 0).any() and (q_want != 0).any()
    k1q, k1sse = cuda_probe.via_k1(torch.from_numpy(pred),
                                   torch.from_numpy(blk), qpd6)
    assert torch.equal(k1q, q) and torch.equal(k1sse, sse)


# ------------------------------------------------------------ K1, build

def test_k1_imma_counts_by_size_read_the_mangled_instantiations():
    ns = "_ZN46_GLOBAL__N__9ef10734_13_fused_eval_cu_f4e2b24b"   # nvcc 12.9
    tail = "EEEvPKhS2_PKaiiNS_8K1ParamsEPsPhPi"
    counts = {ns + "10k1_kernel4EPKhS1_PKaiiNS_8K1ParamsEPsPhPi": 0,
              ns + "12k1_kernel_tcILi8" + tail: 22,
              ns + "12k1_kernel_tcILi16" + tail: 11,
              ns + "12k1_kernel_tcILi32" + tail: 33,
              "_ZN41_GLOBAL__N__fc5085c3_9_probes_cu_aa23f5889p3_fused4EPKhS1_"
              "PKaxiNS_8P3ParamsEPiS5_": 11}
    assert fused_eval.imma_by_size(counts) == {4: 0, 8: 22, 16: 11, 32: 33}


def _stand_in_build(tmp_path, monkeypatch):
    """runtime/build.build of tmp_path/k.cu with the header k.cuh, through
    a stand-in compiler that writes its output and counts its runs in
    tmp_path/log. Returns (build(flags), src, hdr, log)."""
    from hevce_tpu_torch.runtime import build as _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    src, hdr, log = (tmp_path / n for n in ("k.cu", "k.cuh", "log"))
    src.write_text("x")
    hdr.write_text("y")
    log.write_text("")
    cmd = [sys.executable, "-c",
           "import sys; open(sys.argv[-1], 'w').write('lib'); "
           f"open({str(log)!r}, 'a').write('.')"]
    return (lambda *flags: _build.build(src, "libk.so", cmd + list(flags),
                                        deps=[hdr]),
            src, hdr, log)


def test_build_redoes_a_library_when_its_header_changes(tmp_path,
                                                        monkeypatch):
    build, src, hdr, log = _stand_in_build(tmp_path, monkeypatch)
    out, _ = build()
    assert out.read_text() == "lib" and log.read_text() == "."
    assert out.name.startswith("libk.") and out.suffix == ".so"
    old = out.stat().st_mtime - 1000
    hdr.write_text("y2")                 # new contents, an older time
    os.utime(hdr, (old, old))
    out2, _ = build()
    assert log.read_text() == ".." and out2 != out and out2.exists()


def test_build_redoes_a_library_when_its_flags_change(tmp_path,
                                                      monkeypatch):
    build, src, hdr, log = _stand_in_build(tmp_path, monkeypatch)
    out, _ = build("-DA=1")
    out2, _ = build("-DA=2")
    assert log.read_text() == ".." and out2 != out
    assert build("-DA=1")[0] == out and log.read_text() == ".."


def test_build_keeps_the_library_of_an_untouched_tree(tmp_path,
                                                      monkeypatch):
    build, src, hdr, log = _stand_in_build(tmp_path, monkeypatch)
    out, text = build()
    later = out.stat().st_mtime + 1000
    os.utime(src, (later, later))        # touched, not changed
    os.utime(hdr, (later, later))
    assert build() == (out, "") and log.read_text() == "."
    src.write_text("x2")
    assert build()[0] != out and log.read_text() == ".."


# ------------------------------------------------------------------ tools

def test_cuda_probe_on_cpu_prints_exact_lines(capsys):
    assert cuda_probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln[:2] for ln in out[1:]] == ["P1", "P1", "P2", "P3", "P3"]
    assert "EXACT" in out[3] and out[4].count("EXACT") == 4
    assert not any("MISMATCH" in ln for ln in out)


def test_cuda_probe_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_probe.main([])


def test_device_trace_records_on_cpu(tmp_path):
    with device_trace(tmp_path / "t") as prof:
        torch.ones(64, dtype=torch.int32).cumsum(0)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_profiler_sessions_keep_cupti_subscribed(tmp_path, monkeypatch):
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    with device_trace(tmp_path / "t"):
        pass
    assert os.environ["TEARDOWN_CUPTI"] == "0"


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("empty", [0, 1, timing.PROFILE_TRIES])
def test_card_ms_runs_an_empty_profiler_session_again(monkeypatch, empty,
                                                      short):
    """`empty` sessions record no kernel (or, `short`, one of 3 calls'
    launches of "c" is lost); then card_ms reads the profiler's 600 us over
    3 calls, or after PROFILE_TRIES such sessions the CUDA events' time."""
    sessions, calls = [], []
    lost = [("k", 400.0, 3), ("c", 130.0, 2)] if short else []

    def kernels(fn):
        fn()
        sessions.append(len(calls))
        return lost if len(sessions) <= empty else [("k", 400.0, 3),
                                                    ("c", 200.0, 3)]

    monkeypatch.setattr(timing, "card_kernels", kernels)
    monkeypatch.setattr(timing, "busy_events_ms", lambda fn, reps: 7.0)
    monkeypatch.setattr(timing, "EMPTY_SESSIONS", 0)
    monkeypatch.setattr(timing, "EVENT_TIMED", 0)
    ms = timing.card_ms(lambda: calls.append(1), 3)
    fell_back = empty == timing.PROFILE_TRIES
    assert ms == pytest.approx(7.0 if fell_back else 0.2)
    assert len(sessions) == min(empty + 1, timing.PROFILE_TRIES)
    assert len(calls) == 3 * len(sessions)
    assert (timing.EMPTY_SESSIONS, timing.EVENT_TIMED) == (empty, fell_back)


def test_profile_front_on_one_32x32_image_cpu(tmp_path):
    img = np.random.default_rng(6).integers(0, 256, (32, 32)).astype(np.uint8)
    imageio.write_pgm(tmp_path / "a.pgm", img)
    lines = []
    assert profile_front.main([str(tmp_path / "a.pgm"), "--device", "cpu",
                               "--top", "5", "--logdir",
                               str(tmp_path / "trace")], out=lines.append) == 0
    assert lines[0].startswith("batch: B=1 32x32 qpd6=2 on cpu: 1 front")
    assert lines[1].startswith("host (CPU) operator time")
    assert len(lines) == 3 + 5
    assert (tmp_path / "trace" / "trace.json").exists()


def test_bench_fused_on_cpu():
    lines = []
    assert bench_fused.main(["4,35", "--n1", "1", "--n2", "2", "--device",
                             "cpu"], out=lines.append) == 0
    assert lines[0] == ("sz=4 M=35 lanes=288 on cpu: exactness q=OK recon=OK "
                        "sse=OK")
    assert len(lines) == 3 and "host (CPU) clock" in lines[1]


def test_pgm_io_matches_jax_package(tmp_path):
    img = np.random.default_rng(7).integers(0, 256, (13, 21)).astype(np.uint8)
    imageio.write_pgm(tmp_path / "a.pgm", img)
    jimageio.write_pgm(tmp_path / "b.pgm", img)
    assert (tmp_path / "a.pgm").read_bytes() == (tmp_path / "b.pgm").read_bytes()
    (tmp_path / "c.pgm").write_bytes(b"P5 # comment\n21\n13 255\n" + img.tobytes())
    for p in ("a.pgm", "c.pgm"):
        np.testing.assert_array_equal(imageio.read_pgm(tmp_path / p), img)
        np.testing.assert_array_equal(imageio.read_pgm(tmp_path / p),
                                      jimageio.read_pgm(tmp_path / p))
