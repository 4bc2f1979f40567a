"""The rounding points of the port's tensor-core flash kernels
(``fwd_tc_kernel``, ``dq_tc_kernel`` and ``dkv_tc_kernel`` in
imagent_tpu_torch/csrc/flash_attention.cu), emulated in plain torch on
the CPU and held to the JAX package's interpret-mode Pallas kernel.

The TPU kernel multiplies P (in P.V and P^T.dO) and dS (in dS.K and
dS^T.Q) as fp32 operands. The bf16 tensor-core kernels feed ``mma``
bf16 operands only, so they split each of P and dS into hi = bf16(x)
and lo = bf16(x - hi) and issue one product for each: about 16 mantissa
bits. The emulation below repeats that (the forward tile by tile, with the
kernel's 64-key online softmax), rounds the outputs to bf16 as the
kernels do, and must sit within the card bound that chip_smoke.py
holds the kernels to (``1e-3 + |ref|/64``) at the ViT-B/16 sequence
length and head dim. Rounding P and dS to bf16 once, the alternative,
is emulated beside it to show what the split buys. This is test code
only: the port has no such option.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imagent_tpu.ops.flash_attention import flash_attention as jax_flash
from imagent_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

CARD_ATOL, CARD_RTOL = 1e-3, 1 / 64  # chip_smoke.py _TOL["bfloat16"]
N, D = 197, 64  # ViT-B/16 at 224 px
KEY_TILE = 64   # the forward kernel's K/V tile


def _round(x, mode):
    """x as the kernels feed it to ``mma``: ``split`` = bf16 hi + lo,
    ``single`` = bf16 once, ``None`` = exact fp32."""
    if mode is None:
        return x
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if mode == "split" else hi


def emulate_fwd(q, k, v, mode):
    """O in fp32 as fwd_tc_kernel forms it: 64-key tiles, running max,
    l summed from fp32 P, P rounded by ``mode`` before P.V."""
    b, n, h, d = q.shape
    s = fa._scores(q, k)
    m = torch.full((b, h, n, 1), -0.7 * torch.finfo(torch.float32).max)
    l = torch.zeros((b, h, n, 1))
    acc = torch.zeros((b, h, n, d))
    vh = v.float().transpose(1, 2)
    for k0 in range(0, n, KEY_TILE):
        st = s[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _round(p, mode) @ vh[:, :, k0:k0 + KEY_TILE]
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


def emulate_dkv(q, k, v, do, lse, di, mode):
    """(dK, dV) in fp32 as dkv_tc_kernel forms them: P and dS from fp32
    products, rounded by ``mode`` before dV = P^T.dO and dK = dS^T.Q."""
    p, ds = fa._p_and_ds(q, k, v, do, lse, di)
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, mode), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", _round(ds, mode), q.float())
    return dk * q.shape[-1] ** -0.5, dv


def emulate_dq(q, k, v, do, lse, di, mode):
    """dQ in fp32 as dq_tc_kernel forms it: S and dP from exact bf16
    products with fp32 accumulation, P and dS on them in fp32, dS rounded
    by ``mode`` before dQ = scale * dS.K."""
    _, ds = fa._p_and_ds(q, k, v, do, lse, di)
    dq = torch.einsum("bhqk,bkhd->bqhd", _round(ds, mode), k.float())
    return dq * q.shape[-1] ** -0.5


def _inputs(seed, b=1, h=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, N, h, D))
                             .astype(np.float32)).bfloat16()
            for _ in range(4)]


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _to_torch(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def test_split_rounding_fits_card_bound_against_jax_kernel():
    q, k, v, do = _inputs(11)
    jq, jk, jv, jdo = map(_to_jax, (q, k, v, do))
    want_o = _to_torch(jax_flash(jq, jk, jv, interpret=True))

    def loss(q_, k_, v_):  # the cotangent of O is dO
        o = jax_flash(q_, k_, v_, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    want_dk, want_dv = map(_to_torch,
                           jax.grad(loss, argnums=(1, 2))(jq, jk, jv))

    o = emulate_fwd(q, k, v, "split").bfloat16()
    _, lse = fa.fwd_plain(q, k, v)
    di = fa.delta(do, o)
    dk, dv = (x.bfloat16() for x in emulate_dkv(q, k, v, do, lse, di,
                                                "split"))
    for name, got, want in (("O", o, want_o), ("dK", dk, want_dk),
                            ("dV", dv, want_dv)):
        torch.testing.assert_close(got.float(), want, atol=CARD_ATOL,
                                   rtol=CARD_RTOL, msg=name)


def test_split_operands_beat_single_rounding():
    """Before the bf16 output cast, the hi + lo split sits at least 100x
    closer to the exact fp32 products than one bf16 rounding (about 16
    mantissa bits against 8). Supplementary: it compares the emulations
    with one another; the check against the JAX kernel is
    ``test_split_rounding_fits_card_bound_against_jax_kernel``."""
    q, k, v, do = _inputs(12, b=2)
    _, lse = fa.fwd_plain(q, k, v)
    di = fa.delta(do, fa.fwd_plain(q, k, v)[0])
    exact = [emulate_fwd(q, k, v, None),
             *emulate_dkv(q, k, v, do, lse, di, None)]
    errs = {}
    for mode in ("single", "split"):
        got = [emulate_fwd(q, k, v, mode),
               *emulate_dkv(q, k, v, do, lse, di, mode)]
        errs[mode] = [float((g - e).abs().max()) for g, e in zip(got, exact)]
    for name, single, split in zip(("O", "dK", "dV"), errs["single"],
                                   errs["split"]):
        assert split * 100 < single, (name, split, single)


def test_emulated_forward_tiles_match_plain_softmax():
    """With no operand rounded, the tile-by-tile emulation is the plain
    forward (fp32, the JAX package's 2e-5)."""
    q, k, v, _ = (x.float() for x in _inputs(13))
    want, _ = fa.fwd_plain(q, k, v)
    torch.testing.assert_close(emulate_fwd(q, k, v, None), want,
                               atol=2e-5, rtol=2e-5)


def test_dq_split_rounding_fits_card_bound_against_jax_kernel():
    """dQ with dS split into bf16 hi + lo, rounded to bf16 once at the
    end, against the interpret-mode Pallas ``_dq_kernel`` (the gradient
    of the JAX flash attention with respect to q) at the card bound."""
    q, k, v, do = _inputs(14)
    jq, jk, jv, jdo = map(_to_jax, (q, k, v, do))

    def loss(q_):  # the cotangent of O is dO
        o = jax_flash(q_, jk, jv, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = _to_torch(jax.grad(loss)(jq))
    o = emulate_fwd(q, k, v, "split").bfloat16()
    _, lse = fa.fwd_plain(q, k, v)
    got = emulate_dq(q, k, v, do, lse, fa.delta(do, o), "split").bfloat16()
    torch.testing.assert_close(got.float(), want, atol=CARD_ATOL,
                               rtol=CARD_RTOL, msg="dQ")
