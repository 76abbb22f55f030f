"""The folded cross-attention core's launch plan and route, on the CPU.

``fold_core_plan`` is ``attention_plan``'s model over the 2H heads of both
branches; it is checked here at every site of the flagship and of v1 (off
the fused route) at 1, 8 and 32 conditioned rows, the CFG constant at
T = S = 1 and the tensor-parallel partial form's heads of one rank, as
``tests/test_torch_attention_plan.py`` checks the fused route's plan: every
query row in one block, every key tile taken by one rank of the split, a
ring of at least 3 stages, shared memory within the card's opt-in limit
and large enough for the Q tile, the ring and the split's combine, the
tiles set by a branch's heads and the grid over both branches'.

The kernel's arithmetic under that plan (``emulate_attention``, the
attention plan tests' emulation, over the 2H heads) is held against
``fold_core_plain`` with ``chip_smoke.TOL["attention"]``. On the CPU the
folded ``CrossAttentionFusion`` keeps its einsum core, bit for bit the
core it had before the kernel, and the route takes the kernel only for
bf16 tensors on the card.
"""

import math
import types

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from lm2a_tpu_torch.core.config import ModelConfig
from lm2a_tpu_torch.models import attention as mattn
from lm2a_tpu_torch.ops import attention as att
from lm2a_tpu_torch.ops import fold_core as fc
from lm2a_tpu_torch.ops import resblock as rb

from _torch_port_util import one_torch_thread  # noqa: F401
from test_torch_attention_plan import emulate_attention

HEADS = ModelConfig().attn_heads
ROWS = (1, 8, 32)  # serve's one conditioned row, gen's 8, the distill teacher's 32


def _sites(mc):
    if mc.arch == "v1":
        return [(t, c // mc.attn_heads) for _, t, c in
                chip_smoke.v1_attention_sites(mc, chip_smoke.MEL_T)]
    return [(t, c // mc.attn_heads) for _, t, c in
            chip_smoke.attention_sites(mc, chip_smoke.MEL_T)]


SITES = sorted({(b, h, t, chip_smoke.MEL_T, hd)
                for mc in (ModelConfig(), ModelConfig(arch="v1"))
                for t, hd in _sites(mc) for b in ROWS for h in (HEADS,)}
               | {(1, HEADS, 1, 1, hd) for mc in (ModelConfig(), ModelConfig(arch="v1"))
                  for _, hd in _sites(mc)}
               # the partial form: one rank's 1, 3 or 4 heads
               | {(b, h, t, chip_smoke.MEL_T, hd) for t, hd in _sites(ModelConfig())
                  for b in (1, 8) for h in (1, 3, 4)}
               # narrow bases (window maps) and keys past 1024
               | {(2, 4, 37, 1025, 3), (2, 4, 129, 516, 6), (1, 8, 200, 2000, 32)})


@pytest.mark.parametrize("b,h,t,s,hd", SITES,
                         ids=[f"B{c[0]}-H{c[1]}-T{c[2]}-S{c[3]}-hd{c[4]}" for c in SITES])
def test_fold_core_plan(b, h, t, s, hd):
    p = fc.fold_core_plan(b, h, t, s, hd)
    assert p.mtiles * p.rows >= t > (p.mtiles - 1) * p.rows  # every query row once
    assert p.bn in att.KEY_TILES and p.tiles == math.ceil(s / p.bn)
    assert (p.tiles - 1) * p.bn < s <= p.tiles * p.bn
    assert 1 <= p.split <= min(rb.SPLIT_MAX, p.tiles)
    ranges = rb.k_ranges(p.tiles, p.split)
    assert [j for beg, end in ranges for j in range(beg, end)] == list(range(p.tiles))
    assert att.MIN_STAGES <= p.stages <= att.MAX_STAGES
    # the tiles hold a branch's heads from their window offsets: each
    # branch's rows start on the 8-channel unit
    hoff = max((i * hd) % 8 for i in range(h)) if hd % 8 else 0
    assert p.hdq == att.head_tile(hd, h)[0] and p.hdq >= hd + hoff
    hdv = min(p.hdq, 128)
    assert p.vparts * hdv >= hd
    assert p.hdq <= 128 or p.bn == 64
    rows = p.rows + att.MAX_SPLIT
    need = p.rows * p.hdq * 2 + max(p.stages * p.bn * (p.hdq + hdv) * 2,
                                    (rows * (hdv + 4 + 2) + p.rows // 2 * (att.MAX_SPLIT + 1)) * 4)
    assert need + att._ALIGN <= p.smem <= rb.SMEM_MAX
    # the grid: both branches' heads, at most 65535 along y and z
    assert p.blocks(b, 2 * h) == p.split * p.mtiles * 2 * h * p.vparts * b
    assert 2 * h * p.vparts <= 65535 and b <= 65535
    cands = att.attention_candidates(b, h, t, s, hd, branches=2)
    assert any(q == p and c == min(c for c, _ in cands) for c, q in cands)


@pytest.mark.parametrize("h,hd,t,s", [(2, 32, 37, 300), (3, 64, 129, 516), (2, 6, 65, 129),
                                      (1, 96, 1, 1), (2, 16, 100, 1025)])
def test_fold_core_emulation_matches_plain(h, hd, t, s):
    """The kernel's arithmetic under the folded plan, the 2H heads of both
    branches at once, against ``fold_core_plain``."""
    gen = torch.Generator().manual_seed(h * hd + t)
    b, c = 2, h * hd
    q = torch.randn((b, t, 2 * c), generator=gen).bfloat16()
    kvs = [torch.randn((b, s, c), generator=gen).bfloat16() for _ in range(4)]
    plain = fc.fold_core_plain(q, *kvs, h)
    heads = [x.view(b, x.shape[1], -1, hd).transpose(1, 2).float() for x in (q, *kvs)]
    k = torch.cat([heads[1], heads[3]], dim=1)
    v = torch.cat([heads[2], heads[4]], dim=1)
    plan = fc.fold_core_plan(b, h, t, s, hd)
    got = emulate_attention(heads[0], k, v, plan).transpose(1, 2).reshape(b, t, 2 * c)
    torch.testing.assert_close(got.float(), plain.float(), **chip_smoke.TOL["attention"])


def _parent_core(module, mel_hidden, motion_f, text_f, partial=False):
    """``_forward_folded`` as it was before the kernel: the einsum core."""
    f = module.folded
    dt = f["wq"].dtype
    hd = module.mel_dim // module.num_heads
    h = f["wq"].shape[0] // (2 * hd)
    b, t = mel_hidden.shape[:2]
    q = F.linear(mel_hidden.to(dt), f["wq"], f["bq"]).reshape(b, t, 2, h, hd)
    ks, vs = [], []
    for kv_proj, attn, cond in ((module.motion_kv_proj, module.attn_motion, motion_f),
                                (module.text_kv_proj, module.attn_text, text_f)):
        kv = kv_proj(cond.to(dt))
        ks.append(attn.k_proj(kv))
        vs.append(attn.v_proj(kv))
    s = ks[0].shape[1]
    k = torch.stack(ks, dim=2).reshape(b, s, 2, h, hd)
    v = torch.stack(vs, dim=2).reshape(b, s, 2, h, hd)
    scores = torch.einsum("bqnhd,bknhd->bnhqk", q, k) / mattn._inv_scale(hd, q)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    core = torch.einsum("bnhqk,bknhd->bqnhd", probs, v).reshape(b, t, 2 * h * hd)
    return F.linear(core, f["w_out"], None if partial else f["b_out"])


def _folded_site(mel_dim, heads, dtype, seed=0):
    torch.manual_seed(seed)
    m = mattn.CrossAttentionFusion(mel_dim, cond_dim=8, num_heads=heads)
    m.fold(dtype)
    return m.to(dtype).eval()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mel_dim,heads,t,s", [(32, 4, 37, 29), (64, 8, 1, 1), (24, 4, 16, 9)])
@pytest.mark.parametrize("partial", [False, True])
def test_cpu_folded_form_is_the_einsum_core(dtype, mel_dim, heads, t, s, partial):
    m = _folded_site(mel_dim, heads, dtype, seed=mel_dim + t)
    gen = torch.Generator().manual_seed(t + s)
    x = torch.randn((3, t, mel_dim), generator=gen).to(dtype)
    mot, txt = (torch.randn((3, s, 8), generator=gen).to(dtype) for _ in range(2))
    with torch.no_grad():
        got = m._forward_folded(x, mot, txt, partial=partial)
        want = _parent_core(m, x, mot, txt, partial=partial)
    assert torch.equal(got, want)


def test_route_takes_the_kernel_only_for_bf16_on_the_card():
    def stub(device, dtype):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype)

    assert mattn.fold_kernel_route(stub("cuda", torch.bfloat16))
    assert mattn.fold_kernel_route(stub("cuda:1", torch.bfloat16))
    for device, dtype in (("cuda", torch.float32), ("cuda", torch.float16),
                          ("cpu", torch.bfloat16), ("cpu", torch.float32),
                          ("meta", torch.bfloat16)):
        assert not mattn.fold_kernel_route(stub(device, dtype)), (device, dtype)
    assert not mattn.fold_kernel_route(torch.zeros(1, dtype=torch.bfloat16))


def test_route_hands_the_kernel_both_branches(monkeypatch):
    """On the kernel's route the folded form gives ``fold_core`` the merged
    projection and each branch's K and V as the projections left them,
    motion first, and fuses what it returns; run here through the CPU's
    plain version, against the einsum core."""
    m = _folded_site(64, 8, torch.bfloat16, seed=3)
    calls = []

    def spy(q, k_m, v_m, k_t, v_t, heads):
        calls.append((q.shape, k_m.shape, v_t.shape, heads,
                      all(x.is_contiguous() for x in (q, k_m, v_m, k_t, v_t))))
        return fc.fold_core_plain(q, k_m, v_m, k_t, v_t, heads)

    monkeypatch.setattr(mattn, "fold_kernel_route", lambda x: True)
    monkeypatch.setattr(mattn, "fold_core", spy)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 33, 64), generator=gen).bfloat16()
    mot, txt = (torch.randn((2, 17, 8), generator=gen).bfloat16() for _ in range(2))
    with torch.no_grad():
        got = m(x, mot, txt)
        want = _parent_core(m, x, mot, txt)
    assert calls == [((2, 33, 128), (2, 17, 64), (2, 17, 64), 8, True)]
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


def test_fold_core_refuses_what_it_cannot_take():
    q = torch.zeros((1, 4, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 3, 8), dtype=torch.bfloat16)
    for x in (q, q.to("meta")):  # no plain fallback: the route sends only the card's tensors
        with pytest.raises(ValueError, match="on the card"):
            fc.fold_core(x, k, k, k, k, 2)
    for args, match in (((q.float(), k, k, k, k, 2), "bf16"),
                        ((q, k[..., :4], k, k, k, 2), "must be"),
                        ((q, k, k, k, k, 3), "two branches")):
        with pytest.raises(ValueError, match=match):
            fc._check(args[0], args[1:5], args[5])
