"""The port's unary chain (ops/unary_chain.py, the plain version of P2) and
its probe entry point against the JAX probe, on the CPU.

The same numpy block goes through the kernel that ``make_kernel`` of the
JAX package's ``scripts/probe_exp.py`` builds (``pl.pallas_call`` in
interpret mode; the module is imported by path) and through the port, for
every op, working type and a few chain lengths. Tolerances: fp32, 1e-5 of
the output's largest magnitude (XLA's exp and tanh are other
approximations than PyTorch's, and the error of a chain that crosses zero
is not small relative to each element); bf16, two bf16 ulps of each
element (the plain version rounds at every elementary operation, as JAX
does).
"""
import importlib.util
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssl_vit_video_analytics_tpu_torch.ops import unary_chain as uc
from ssl_vit_video_analytics_tpu_torch.scripts import probe_exp, time_ms

torch.set_num_threads(2)  # six test workers share the host

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_probe_exp", REPO / "scripts" / "probe_exp.py")
jax_probe_exp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_probe_exp)

SHAPE = (8, 128)
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("n", [1, 5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("op", uc.OPS)
def test_plain_matches_pallas_chain(op, dtype, n):
    x = np.random.default_rng(n).standard_normal(SHAPE).astype(np.float32)
    ref = np.asarray(pl.pallas_call(
        jax_probe_exp.make_kernel(n, JAX_DTYPES[dtype], op),
        out_shape=jax.ShapeDtypeStruct(SHAPE, jnp.float32), interpret=True)(jnp.asarray(x)))
    got = uc.unary_chain_plain(torch.from_numpy(x), n, dtype, op)
    assert got.shape == SHAPE and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        assert (np.abs(got - ref) <= 2 * bf16_ulp(ref)).all()


def test_wrapper_refuses_what_it_cannot_run():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="unknown op"):
        uc.unary_chain(x, 2, torch.float32, "sin")
    with pytest.raises(ValueError, match="no unary-chain kernel"):
        uc.unary_chain(x.to("meta"), 2, torch.float32, "exp")


def test_probe_entry_on_cpu():
    before = uc.launches.count
    rows = probe_exp.run(rows=8, lanes=128, lo=1, hi=3, device="cpu", iters=1, plain_iters=1,
                         log=lambda _: None, mid=2)
    assert uc.launches.count == before
    assert [(r["op"], r["dtype"]) for r in rows] == [
        (op, dt) for op in uc.OPS for dt in ("float32", "bfloat16")]
    for row in rows:
        assert row["numel"] == 8 * 128 and row["t_hi_ms"] > 0 and row["plain_t_hi_ms"] > 0
        assert (row["lo"], row["mid"], row["hi"]) == (1, 2, 3) and row["t_mid_ms"] > 0
        assert row["per_application_ops_ms"] == pytest.approx(row["t_hi_ms"] - row["t_mid_ms"])
        assert row["per_application_ms"] == pytest.approx((row["t_hi_ms"] - row["t_lo_ms"]) / 2)
    # per application to 896 x 6272 elements on an H100: one MUFU op per
    # element at 16 a clock on 132 SMs at 1.98 GHz, or FMA-pipe ops at 128:
    # in fp32 gelu's 9 multiplies and adds outlast its tanh, fma's 2 do not
    numel = probe_exp.ROWS * probe_exp.LANES
    mufu_ms = numel / (132 * 16 * 1.98e9) * 1e3
    f32 = torch.float32
    assert probe_exp.per_application_bound_ms("exp", f32, numel) == pytest.approx(mufu_ms)
    assert probe_exp.per_application_bound_ms("gelu", f32, numel) == pytest.approx(
        mufu_ms * 9 / 8)
    assert probe_exp.per_application_bound_ms("fma", f32, numel) == pytest.approx(mufu_ms / 4)
    # the block moves once: 45 MB at 3.35 TB/s, above 4 applications of
    # fma, below 516
    assert probe_exp.call_bound_ms("fma", f32, numel, 4)[1] == "bytes"
    assert probe_exp.call_bound_ms("fma", f32, numel, 516) == pytest.approx(
        (516 * mufu_ms / 4, "operations"))
    assert [r["bound_per_application_ms"] for r in rows] == [
        probe_exp.per_application_bound_ms(op, dt, 8 * 128) for op in uc.OPS for dt in uc.DTYPES]


def test_bf16_bounds_count_packed_ops_as_half():
    """In bf16 a packed multiply or add serves two elements (256 16-bit
    results per clock per SM): fma's bound halves to about 0.168 us at the
    probe's block, gelu's 9 packed ops fall below its tanh, so every bf16
    row but fma is MUFU-bound, and no bf16 bound exceeds fp32's."""
    numel = probe_exp.ROWS * probe_exp.LANES
    mufu_ms = numel / (132 * 16 * 1.98e9) * 1e3
    bf16, f32 = torch.bfloat16, torch.float32
    for op in ("exp", "tanh", "gelu"):
        assert probe_exp.per_application_bound_ms(op, bf16, numel) == pytest.approx(mufu_ms)
    fma = probe_exp.per_application_bound_ms("fma", bf16, numel)
    assert fma == pytest.approx(mufu_ms / 8) and fma * 1e3 == pytest.approx(0.168, abs=1e-3)
    for op in uc.OPS:
        assert (probe_exp.per_application_bound_ms(op, bf16, numel)
                <= probe_exp.per_application_bound_ms(op, f32, numel))
    assert probe_exp.call_bound_ms("fma", bf16, numel, 516) == pytest.approx(
        (516 * fma, "operations"))


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_122unary_chain_f32_kernelILi3EEEvPKfPfli
        .headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 BRA `(.L_x_1) ;
.L_x_0:
        /*0020*/                   FFMA R4, R4, 0.99909999966621398926, 0.0001 ;
        /*0030*/                   FFMA R5, R5, 0.99909999966621398926, 0.0001 ;
        /*0040*/                   IADD3 R0, R0, 0x4, RZ ;
        /*0050*/                   ISETP.GE.AND P0, PT, R0, R3, PT ;
        /*0060*/               @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0070*/                   FFMA R4, R4, 0.99909999966621398926, 0.0001 ;
        /*0080*/               @P1 BRA `(.L_x_1) ;
        /*0090*/                   EXIT ;
"""


def test_loop_counts_reads_the_main_loop():
    counts = probe_exp.loop_counts(SASS)
    per = probe_exp.UNROLL * probe_exp.ELEMS
    assert counts == {"fma/float32": {"BRA": 1 / per, "FFMA": 2 / per, "IADD3": 1 / per,
                                      "ISETP.GE.AND": 1 / per}}


# a bf16 gelu main loop of one packed pair: the packed arithmetic, the
# widening shifts, a tanh and one packed conversion; and a kernel of
# another name, which is not read
SASS_BF16 = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_125unary_chain_bf16x2_kernelILi2EEEvPKfPfli
        .headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_2:
        /*0010*/                   HADD2.BF16_V2 R4, R4.H0_H0, R9.H0_H0 ;
        /*0020*/                   HMUL2.BF16_V2 R5, R4, R4 ;
        /*0030*/                   HFMA2.BF16_V2 R5, R4, R5, -RZ ;
        /*0040*/                   IMAD.U32 R6, R5, 0x10000, RZ ;
        /*0050*/                   LOP3.LUT R7, R5, 0xffff0000, RZ, 0xc0, !PT ;
        /*0060*/                   MUFU.TANH R6, R6 ;
        /*0070*/                   MUFU.TANH R7, R7 ;
        /*0080*/                   F2FP.BF16.F32.PACK_AB R5, R7, R6 ;
        /*0090*/                   ISETP.GE.AND P0, PT, R0, R3, PT ;
        /*00a0*/               @P0 BRA `(.L_x_2) ;
        /*00b0*/                   EXIT ;
                Function : _ZN12_GLOBAL__N_118unary_chain_kernelILi2ELb1EEEvPKfPfli
.L_x_3:
        /*0000*/                   F2F.BF16.F32 R4, R4 ;
        /*0010*/               @P0 BRA `(.L_x_3) ;
"""


def test_loop_counts_and_conversions_of_a_packed_bf16_loop():
    counts = probe_exp.loop_counts(SASS_BF16)
    per = probe_exp.UNROLL * probe_exp.ELEMS
    assert set(counts) == {"gelu/bfloat16"}
    gelu = counts["gelu/bfloat16"]
    assert gelu["HADD2.BF16_V2"] == gelu["F2FP.BF16.F32.PACK_AB"] == 1 / per
    assert gelu["MUFU.TANH"] == 2 / per
    assert probe_exp.conversions(counts) == {
        "gelu/bfloat16": {"F2F.BF16.F32": 0, "F2FP.": 1 / per}}
    # an fp32 loop has no bf16 conversions to report
    assert probe_exp.conversions(probe_exp.loop_counts(SASS)) == {}


def test_loop_shape_follows_the_kernel_source():
    """loop_counts divides by UNROLL * ELEMS: they are csrc/unary_chain.cu's
    kUnroll and kElems."""
    src = (REPO / "ssl_vit_video_analytics_tpu_torch" / "ops" / "csrc"
           / "unary_chain.cu").read_text()
    assert f"constexpr int kUnroll = {probe_exp.UNROLL};" in src
    assert f"constexpr int kElems = {probe_exp.ELEMS};" in src


def test_time_ms_takes_the_least_window():
    # a stall of 50 ms in the first timed window (calls 3-5 after 2 warm)
    # is the slowest window's, not the result's
    calls = []

    def fn():
        calls.append(None)
        if 3 <= len(calls) <= 5:
            time.sleep(0.05)

    ms = time_ms(fn, torch.device("cpu"), iters=3, warmup=2, repeats=3)
    assert len(calls) == 2 + 3 * 3
    assert ms < 5
    calls.clear()
    assert time_ms(fn, torch.device("cpu"), iters=3, warmup=2) > 40
