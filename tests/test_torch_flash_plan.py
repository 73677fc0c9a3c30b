"""PyTorch port: K5's work plan and its split-precision arithmetic, on the
CPU.

The kernel (``csrc/flash_attention.cu``) runs one CTA a (head, q tile,
chunk of key tiles) and merges the chunks' partials in chunk order; its
products run on the tensor cores in three TF32 passes (3xTF32).  Neither
can run here, so this file holds the Python models of both:

- the items of ``flash_plan``'s chunk size (``plan_items``, in the order
  the kernel's ``chunks_of`` and ``items_before`` number them) cover every
  visible (q, k) pair exactly once, at most eight chunks a q tile, for T
  in {1, 63, 640, 1000}, causal and not; the plan depends on T, dh and the
  mask only, so a head's work is the same at BH 8 and BH 64 and its rows
  come out the same bits;
- the plan-driven chunked softmax (partials, then the merge) and the
  3xTF32 products, on the serving LM's q, k, v (``models/lm.py`` at
  tests/test_torch_lm.py's size, from the JAX package's seeded model) and
  on random q, k, v at the prefill's T, within rtol = atol = 2e-5 of
  ``flash_attention_plain`` and of the JAX kernel (interpret mode), the
  tolerance the JAX kernel is held to.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models.lm import TransformerLMInt8 as JLM
from resnet_accel_tpu.ops.flash_attention import (
    flash_attention as j_flash_attention)
from resnet_accel_tpu_torch.models.lm import from_reference
from resnet_accel_tpu_torch.ops.flash_attention import (
    FA_MAX_CHUNKS, FA_MIN_CHUNK, FA_ROWS, flash_attention_plain, flash_plan)

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LM_CFG = dict(vocab=32, d_model=64, n_heads=4, d_ff=128, n_layers=2,
              max_len=16, sparsity=0.7, block=8, seed=3)


def plan_items(T, causal, ct):
    """The kernel's items for one head, in its order: (q tile, chunk,
    first key tile, end key tile)."""
    nq = -(-T // FA_ROWS)
    items = []
    for qt in range(nq):
        vis = qt + 1 if causal else nq
        for c in range(-(-vis // ct)):
            items.append((qt, c, c * ct, min(vis, (c + 1) * ct)))
    return items


def split_tf32(x: torch.Tensor):
    """x = hi + lo with hi and lo TF32 values, as the kernel splits its fp32
    operands: hi = cvt.rna.tf32(x) (10 mantissa bits, rounded to nearest,
    ties away from zero), lo = cvt.rna.tf32(x - hi)."""
    def rna(t):
        b = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        b = (b + 0x1000) & 0xFFFFE000
        b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
        return b.to(torch.int32).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def dot_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three passes compute it: lo.hi + hi.lo +
    hi.hi of the split operands, each pass exact in float64 and the sum
    rounded to float32 (the tensor cores' own accumulation order is not
    modelled)."""
    ah, al = (t.double() for t in split_tf32(a))
    bh, bl = (t.double() for t in split_tf32(b))
    return (al @ bh + ah @ bl + ah @ bh).float()


def attention_3xtf32(q, k, v, *, causal: bool = False):
    """A CPU model of the kernel's arithmetic: S = Q K^T and O = P V each in
    split precision (the lo.lo term dropped), the softmax in float32."""
    _, T, dh = q.shape
    s = dot_3xtf32(q, k.transpose(1, 2)) * (1.0 / float(np.sqrt(dh)))
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool).tril()
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return dot_3xtf32(p, v) / p.sum(-1, keepdim=True)


def _visible(T, causal):
    v = np.ones((T, T), bool)
    return np.tril(v) if causal else v


@pytest.mark.parametrize("T", [1, 63, 640, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_plan_covers_each_visible_pair_once(T, causal):
    ct, _ = flash_plan(T, 64, causal)
    items = plan_items(T, causal, ct)
    count = np.zeros((T, T), np.int64)
    for qt, c, kt0, kt1 in items:
        assert 0 <= kt0 < kt1 and kt1 - kt0 <= ct
        assert kt0 == c * ct
        rows = slice(qt * FA_ROWS, min(T, (qt + 1) * FA_ROWS))
        keys = slice(kt0 * FA_ROWS, min(T, kt1 * FA_ROWS))
        count[rows, keys] += 1
    vis = _visible(T, causal)
    # each visible pair once; a masked pair at most once (the diagonal
    # tiles compute and mask their upper half)
    assert (count[vis] == 1).all()
    assert count.max() <= 1
    nq = -(-T // FA_ROWS)
    chunks = [sum(1 for it in items if it[0] == qt) for qt in range(nq)]
    assert all(1 <= n <= FA_MAX_CHUNKS for n in chunks)
    # the items run longest walk first in the kernel; none walks past ct
    assert ct == max(FA_MIN_CHUNK, -(-nq // FA_MAX_CHUNKS))


def test_plan_at_the_prefill():
    """T 640, causal: 30 items a head (240 CTAs at BH 8), at most 2 key
    tiles each (the old kernel's last q tile walked 10)."""
    ct, ws_floats = flash_plan(640, 64, True)
    items = plan_items(640, True, ct)
    assert len(items) == 30
    assert max(kt1 - kt0 for _, _, kt0, kt1 in items) == 2
    assert ws_floats == 30 * (64 * 64 + 2 * 64)


@pytest.mark.parametrize("T", [1, 63, 640, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_plan_does_not_depend_on_bh(T, causal):
    """The plan takes no BH: the kernel's grid is (items, BH), head b's
    partials sit at b * ws_floats, so a head computes the same sums at BH
    8 and 64."""
    assert list(inspect.signature(flash_plan).parameters) == [
        "T", "dh", "causal"]
    assert flash_plan(T, 64, causal) == flash_plan(T, 64, causal)
    ct = flash_plan(T, 64, causal)[0]
    items = plan_items(T, causal, ct)
    merge = any(sum(1 for it in items if it[0] == qt) > 1
                for qt in range(-(-T // FA_ROWS)))
    # the workspace: an acc tile at the padded dh and 64 (m, l) pairs an
    # item, where some q tile has partials to merge
    for dh, pad in ((1, 16), (16, 16), (17, 32), (64, 64), (100, 128)):
        assert flash_plan(T, dh, causal) == (
            ct, len(items) * (FA_ROWS * pad + 2 * FA_ROWS) if merge else 0)


def test_split_tf32():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 3, 4096).astype(np.float32))
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1.0, -2.5, 1e-30, 3e30])])
    hi, lo = split_tf32(x)
    for t in (hi, lo):      # TF32: the low 13 mantissa bits are zero
        assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    # hi is x rounded to 10 mantissa bits, and hi + lo leaves at most the
    # bits past a second TF32 value
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= x.abs().double() * 2.0 ** -21).all()


def chunked(q, k, v, causal, scale=None, dot=None):
    """The kernel's algorithm on the CPU, one head at a time: each plan
    item's online softmax over its key tiles (partial m, l, acc), then the
    merge of a q tile's partials in chunk order."""
    BH, T, dh = q.shape
    scale = 1.0 / float(np.sqrt(dh)) if scale is None else scale
    dot = dot or (lambda a, b: a @ b)
    ct, _ = flash_plan(T, dh, causal)
    out = torch.zeros_like(q)
    for b in range(BH):
        parts = {}
        for qt, c, kt0, kt1 in plan_items(T, causal, ct):
            rows = torch.arange(qt * FA_ROWS, min(T, (qt + 1) * FA_ROWS))
            qh = q[b, rows]
            m = torch.full((len(rows), 1), float("-inf"))
            l = torch.zeros((len(rows), 1))
            acc = torch.zeros((len(rows), dh))
            for kt in range(kt0, kt1):
                keys = torch.arange(kt * FA_ROWS, min(T, (kt + 1) * FA_ROWS))
                s = dot(qh, k[b, keys].t()) * scale
                if causal:
                    s = s.masked_fill(keys[None, :] > rows[:, None],
                                      float("-inf"))
                m_new = torch.maximum(m, s.amax(1, keepdim=True))
                corr = torch.where(m_new == float("-inf"), 1.0,
                                   torch.exp(m - m_new))
                p = torch.where(s == float("-inf"), 0.0, torch.exp(s - m_new))
                l = l * corr + p.sum(1, keepdim=True)
                acc = acc * corr + dot(p, v[b, keys])
                m = m_new
            parts.setdefault(qt, []).append((rows, m, l, acc))
        for qt, ps in parts.items():
            rows = ps[0][0]
            M = torch.stack([m for _, m, _, _ in ps]).amax(0)
            lsum = torch.zeros_like(ps[0][2])
            osum = torch.zeros_like(ps[0][3])
            for _, m, l, acc in ps:     # chunk order
                w = torch.where(m == float("-inf"), 0.0, torch.exp(m - M))
                lsum = lsum + l * w
                osum = osum + acc * w
            out[b, rows] = torch.where(lsum == 0, 0.0, osum / lsum)
    return out


@pytest.fixture(scope="module")
def lm_qkv():
    """The serving LM's q, k, v at every layer of a prefill: the JAX
    package's seeded model (tests/test_lm.py's size), converted."""
    jlm = JLM.from_random(**LM_CFG)
    toks = np.random.default_rng(7).integers(0, 32, 16).astype(np.int32)
    scales = jlm.calibrate(toks)
    mod = from_reference(jlm).module("cpu")
    sc = mod.prepare_scales(scales)
    out = []
    with torch.inference_mode():
        x = mod.embed[mod._tokens(toks)] + mod.pos[:len(toks)]
        for i, blk in enumerate(mod.blocks):
            out.append(tuple(blk._heads(t).reshape(-1, len(toks),
                                                   blk.d_model
                                                   // blk.n_heads)
                             .contiguous()
                             for t in blk.qkv_project(x, sc[i])))
            x = blk(x, causal=True, scales=sc[i], flash=True, plain=True)
    return out


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_on_the_lm(lm_qkv, causal):
    for q, k, v in lm_qkv:
        want = flash_attention_plain(q, k, v, causal=causal)
        jax = torch.from_numpy(np.array(j_flash_attention(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal)))
        for got in (attention_3xtf32(q, k, v, causal=causal),
                    chunked(q, k, v, causal, dot=dot_3xtf32)):
            torch.testing.assert_close(got, want, **TOL)
            torch.testing.assert_close(got, jax, **TOL)


@pytest.mark.parametrize("T,causal", [(640, True), (1000, False),
                                      (63, True), (1, True)])
def test_chunked_3xtf32_at_prefill_lengths(T, causal):
    """Random q, k, v (two heads, dh 16): the chunked, split-precision
    model against the plain version, and head 1 alone against head 1 in
    the batch, bit for bit."""
    rng = np.random.default_rng(T)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, T, 16)).astype(
        np.float32)) for _ in range(3))
    got = chunked(q, k, v, causal, dot=dot_3xtf32)
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, causal=causal), **TOL)
    assert torch.equal(chunked(q[1:], k[1:], v[1:], causal,
                               dot=dot_3xtf32)[0], got[1])
