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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssl_vit_video_analytics_tpu_torch.ops import unary_chain as uc
from ssl_vit_video_analytics_tpu_torch.scripts import probe_exp

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
                         log=lambda _: None)
    assert uc.launches.count == before
    assert [(r["op"], r["dtype"]) for r in rows] == [
        (op, dt) for op in uc.OPS for dt in ("float32", "bfloat16")]
    for row in rows:
        assert row["numel"] == 8 * 128 and row["t_hi_ms"] > 0 and row["plain_t_hi_ms"] > 0
    # per application to 896 x 6272 elements on an H100: one MUFU op per
    # element at 16 a clock on 132 SMs at 1.98 GHz, or FMA-pipe ops at 128:
    # gelu's 9 multiplies and adds outlast its tanh, fma's 2 do not
    numel = probe_exp.ROWS * probe_exp.LANES
    mufu_ms = numel / (132 * 16 * 1.98e9) * 1e3
    assert probe_exp.per_application_bound_ms("exp", numel) == pytest.approx(mufu_ms)
    assert probe_exp.per_application_bound_ms("gelu", numel) == pytest.approx(mufu_ms * 9 / 8)
    assert probe_exp.per_application_bound_ms("fma", numel) == pytest.approx(mufu_ms / 4)
    # the block moves once: 45 MB at 3.35 TB/s, above 4 applications of
    # fma, below 516
    assert probe_exp.call_bound_ms("fma", numel, 4)[1] == "bytes"
    assert probe_exp.call_bound_ms("fma", numel, 516) == pytest.approx(
        (516 * mufu_ms / 4, "operations"))


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_118unary_chain_kernelILi3ELb0EEEvPKfPfli
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
