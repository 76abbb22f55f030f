"""The port's loaders of foreign weights against the JAX package's, on
synthetic files made from a seed in the published key layouts (no trained
reference or NVIDIA checkpoint is in the repository).

- A reference ``torch.save`` checkpoint (``unet`` / ``ema_unet`` /
  ``cond_proj`` / ``ema_cond_proj`` state dicts of ``UNet1D_ultimate`` and
  ``CondProjection`` with packed ``nn.MultiheadAttention`` projections, plus
  the scalar entries) at a tiny ``ModelConfig``: ``load_models`` of the port
  against ``load_torch_checkpoint`` of the JAX package, denoiser and
  condition projection forwards in fp32 (1e-5); EMA preference and the meta
  fields; ``cli serve --ckpt`` on such a file.
- NVIDIA BigVGAN generator state dicts with weight norm (``weight_g`` /
  ``weight_v``) nested under ``generator``, for resblock types 1 and 2 and a
  v2 dict without ``conv_post.bias``: the port's converted state dict
  against ``convert_bigvgan`` carried by the flax->torch rule (1e-6: weight
  norm folded in numpy there, in torch here), and ``Vocoder(weights_path=)``
  against the JAX generator on the same file (2e-4 on the [-1, 1]
  waveform, the slice test's figure).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu.core.config import config_to_dict as jax_config_to_dict
from lm2a_tpu.models.factory import build_cond_projection as jax_bcp
from lm2a_tpu.models.factory import build_denoiser as jax_bd
from lm2a_tpu.utils.torch_convert import load_torch_checkpoint as jax_load_torch_checkpoint
from lm2a_tpu.vocoder import Vocoder as JaxVocoder
from lm2a_tpu.vocoder import VocoderConfig as JaxVocoderConfig
from lm2a_tpu.vocoder.convert import convert_bigvgan as jax_convert_bigvgan
from lm2a_tpu_torch.cli import serve
from lm2a_tpu_torch.convert import BIGVGAN_CONV_TRANSPOSE, flatten_params, jax_params_to_torch
from lm2a_tpu_torch.core.config import config_from_dict
from lm2a_tpu_torch.inference import sample
from lm2a_tpu_torch.vocoder.bigvgan import VocoderConfig
from lm2a_tpu_torch.vocoder.convert import convert_bigvgan
from lm2a_tpu_torch.vocoder.vocode import Vocoder

from _torch_port_util import TINY_CFG, one_torch_thread, rand  # noqa: F401

PORT_CFG = config_from_dict(jax_config_to_dict(TINY_CFG))
META = dict(dataset_mean=-4.25, dataset_std=1.75, timesteps=8, guidance_weight=2.5,
            step=120, epoch=3)


# ---------------------------------------------------------------- reference .pt

def reference_state_dicts(mc, seed):
    """``UNet1D_ultimate`` and ``CondProjection`` state dicts in the
    reference's key layout at ``mc``'s geometry, random from ``seed``."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(*shape, scale=0.3):
        return torch.tensor(rand(rng, *shape, scale=scale))

    def linear(p, cout, cin):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t(cout, cin, scale=cin ** -0.5), t(cout, scale=0.1)

    def conv(p, cout, cin, k):
        sd[f"{p}.weight"] = t(cout, cin, k, scale=(cin * k) ** -0.5)
        sd[f"{p}.bias"] = t(cout, scale=0.1)

    def gn(p, c):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = 1 + t(c, scale=0.1), t(c, scale=0.1)

    def block(p, cin, cout, attn):
        gn(f"{p}.gn1", cin)
        conv(f"{p}.conv1", cout, cin, 3)
        linear(f"{p}.film.net.1", 2 * cout, mc.time_emb_dim)
        gn(f"{p}.gn2", cout)
        conv(f"{p}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{p}.skip", cout, cin, 1)
        if attn:
            a = f"{p}.cross_attn"
            linear(f"{a}.motion_kv_proj", cout, mc.cond_dim)
            linear(f"{a}.text_kv_proj", cout, mc.cond_dim)
            linear(f"{a}.fuse_proj", cout, 2 * cout)
            for br in ("attn_motion", "attn_text"):
                sd[f"{a}.{br}.in_proj_weight"] = t(3 * cout, cout, scale=cout ** -0.5)
                sd[f"{a}.{br}.in_proj_bias"] = t(3 * cout, scale=0.1)
                linear(f"{a}.{br}.out_proj", cout, cout)

    linear("time_embedding.time_mlp.1", mc.time_emb_dim, mc.time_emb_dim)
    conv("in_proj", mc.base_dim, mc.in_dim, 1)
    dims = [mc.base_dim * m for m in mc.dim_mults]
    prev = mc.base_dim
    for i, dim in enumerate(dims):
        for b in range(mc.num_res_blocks):
            block(f"downs.{i}.blocks.{b}", prev, dim, b == mc.num_res_blocks - 1)
            prev = dim
        conv(f"downs.{i}.down.conv", dim, dim, 4)
    for b in range(mc.mid_blocks):
        block(f"mid.blocks.{b}", prev, prev, True)
    for i, dim in enumerate(reversed(dims)):
        conv(f"ups.{i}.up.conv", dim, prev, 3)
        for b in range(mc.num_res_blocks):
            block(f"ups.{i}.blocks.{b}", 2 * dim if b == 0 else dim, dim, b == 0)
        prev = dim
    gn("out_proj.0", prev)
    conv("out_proj.2", mc.in_dim, prev, 1)
    proj = {}
    for name, cin in (("motion_proj", mc.motion_dim), ("text_proj", mc.text_dim)):
        proj[f"{name}.weight"] = t(mc.cond_dim, cin, scale=cin ** -0.5)
        proj[f"{name}.bias"] = t(mc.cond_dim, scale=0.1)
    return sd, proj


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    unet, proj = reference_state_dicts(TINY_CFG.model, seed=0)
    ema_unet, ema_proj = reference_state_dicts(TINY_CFG.model, seed=1)
    path = str(tmp_path_factory.mktemp("ref") / "ckpt.pt")
    torch.save(dict(unet=unet, ema_unet=ema_unet, cond_proj=proj, ema_cond_proj=ema_proj,
                    **META), path)
    return path, (unet, proj), (ema_unet, ema_proj)


@pytest.mark.parametrize("prefer_ema", [True, False])
def test_reference_pt_matches_jax_loader(reference_pt, prefer_ema):
    path, plain_sds, ema_sds = reference_pt
    mc = TINY_CFG.model
    models = sample.load_models(path, cfg=PORT_CFG, prefer_ema=prefer_ema, device="cpu",
                                compute_dtype="float32")
    unet_p, proj_p, meta = jax_load_torch_checkpoint(path, mc, prefer_ema=prefer_ema)
    assert meta == META
    assert (models.dataset_mean, models.dataset_std) == (-4.25, 1.75)
    assert (models.timesteps, models.guidance_weight) == (8, 2.5)
    unet_sd, proj_sd = ema_sds if prefer_ema else plain_sds
    np.testing.assert_array_equal(models.cond_proj.motion_proj.weight.numpy(),
                                  proj_sd["motion_proj.weight"].numpy())
    packed = unet_sd["mid.blocks.0.cross_attn.attn_text.in_proj_bias"].numpy()
    np.testing.assert_array_equal(  # the third of the packed q/k/v rows
        models.denoiser.mid_block_0.cross_attn.attn_text.v_proj.bias.numpy(),
        packed[2 * len(packed) // 3:])

    rng = np.random.default_rng(2)
    t = 13
    x = rand(rng, 2, t, mc.in_dim)
    m_f, t_f = rand(rng, 2, t, mc.cond_dim), rand(rng, 2, t, mc.cond_dim)
    ts = np.array([3, 6], np.int32)
    want = jax.jit(jax_bd(mc).apply)(unet_p, x, ts, m_f, t_f)
    got = models.denoiser(torch.tensor(x), torch.tensor(ts).long(), torch.tensor(m_f),
                          torch.tensor(t_f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    motion, lyrics = rand(rng, 2, t, mc.motion_dim), rand(rng, 2, t, mc.text_dim)
    for g, w in zip(models.cond_proj(torch.tensor(motion), torch.tensor(lyrics)),
                    jax_bcp(mc).apply(proj_p, motion, lyrics)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_cli_serve_takes_a_reference_pt(reference_pt, tmp_path, monkeypatch, capsys):
    """``cli serve --ckpt x.pt``: a .pt carries no config, so ``load_models``
    builds ``LM2AConfig()``; the test points that default at the tiny
    geometry the file was made with."""
    path = reference_pt[0]
    monkeypatch.setattr(sample, "LM2AConfig", lambda: PORT_CFG)
    (clip,) = chip_smoke.write_clips(str(tmp_path / "clips"), 1, seed=3, mel_t=24, motion_t=9)
    reqs = [{"npz": clip, "id": "a", "out_dir": str(tmp_path / "out")}, {"cmd": "quit"}]
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)))
    serve.main(["--ckpt", path, "--device", "cpu", "--method", "ddim", "--ddim_steps", "2"])
    resp = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert resp[0]["ok"] and resp[1]["bye"]
    mel = np.load(resp[0]["out"])["mel"]
    assert mel.shape == (80, 24) and np.isfinite(mel).all()


def test_missing_weights_are_named(reference_pt, tmp_path):
    unet, proj = reference_state_dicts(TINY_CFG.model, seed=0)
    del unet["mid.blocks.0.cross_attn.attn_text.in_proj_weight"]
    path = str(tmp_path / "broken.pt")
    torch.save(dict(unet=unet, cond_proj=proj), path)
    with pytest.raises(KeyError, match="attn_text.q_proj.weight"):
        sample.load_models(path, cfg=PORT_CFG, device="cpu")


# ---------------------------------------------------------------- NVIDIA BigVGAN

VOC = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 2)))
VOCODERS = {
    "type1": dict(VOC),
    "type2": dict(VOC, resblock_type="2"),
    "v2_no_final_bias": dict(VOC, use_bias_at_final=False, use_tanh_at_final=False),
}


def nvidia_state_dict(cfg, seed):
    """Weight-normed generator state dict in NVIDIA's key layout, built as
    ``tests/test_vocoder.py`` (``TestConvert._fake_torch_sd``) builds it,
    with resblock type '2' and the bias-less v2 ``conv_post`` added."""
    rng = np.random.default_rng(seed)
    sd = {}

    def weight_norm(prefix, shape):
        v = rng.standard_normal(shape).astype(np.float32)
        sd[prefix + ".weight_g"] = (np.linalg.norm(v.reshape(shape[0], -1), axis=1)
                                    .reshape(shape[0], 1, 1) * 0.5).astype(np.float32)
        sd[prefix + ".weight_v"] = v

    def conv(prefix, cout, cin, k, bias=True):
        weight_norm(prefix, (cout, cin, k))
        if bias:
            sd[prefix + ".bias"] = rng.standard_normal(cout).astype(np.float32)

    def convt(prefix, cin, cout, k):
        weight_norm(prefix, (cin, cout, k))
        sd[prefix + ".bias"] = rng.standard_normal(cout).astype(np.float32)

    def snake(prefix, ch):
        sd[prefix + ".alpha"] = (0.3 * rng.standard_normal(ch)).astype(np.float32)
        sd[prefix + ".beta"] = (0.3 * rng.standard_normal(ch)).astype(np.float32)

    ch = cfg.upsample_initial_channel
    conv("conv_pre", ch, cfg.num_mels, 7)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (r, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        convt(f"ups.{i}.0", ch, ch // 2, k)
        ch //= 2
        for j, (rk, dil) in enumerate(zip(cfg.resblock_kernel_sizes,
                                          cfg.resblock_dilation_sizes)):
            rb = f"resblocks.{i * nk + j}"
            for m in range(len(dil)):
                if cfg.resblock_type == "1":
                    conv(f"{rb}.convs1.{m}", ch, ch, rk)
                    conv(f"{rb}.convs2.{m}", ch, ch, rk)
                    snake(f"{rb}.activations.{2 * m}.act", ch)
                    snake(f"{rb}.activations.{2 * m + 1}.act", ch)
                else:
                    conv(f"{rb}.convs.{m}", ch, ch, rk)
                    snake(f"{rb}.activations.{m}.act", ch)
    snake("activation_post.act", ch)
    conv("conv_post", 1, ch, 7, bias=cfg.use_bias_at_final)
    return sd


@pytest.mark.parametrize("name", sorted(VOCODERS))
def test_bigvgan_weights_match_jax(name, tmp_path):
    cfg, jcfg = VocoderConfig(**VOCODERS[name]), JaxVocoderConfig(**VOCODERS[name])
    sd = nvidia_state_dict(cfg, seed=len(name))
    assert ("conv_post.bias" in sd) == cfg.use_bias_at_final
    got = convert_bigvgan({k: torch.tensor(v) for k, v in sd.items()}, cfg)
    want = jax_params_to_torch(flatten_params(jax_convert_bigvgan(sd, jcfg)["params"]),
                               BIGVGAN_CONV_TRANSPOSE)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)

    path = str(tmp_path / "g_00000000.pt")
    torch.save({"generator": {k: torch.tensor(v) for k, v in sd.items()}}, path)
    mel = rand(np.random.default_rng(5), 1, 80, 12) - 4.0
    wav = Vocoder(weights_path=path, cfg=cfg, device="cpu",
                  compute_dtype="float32").mel_to_wav(mel)
    jwav = JaxVocoder(weights_path=path, cfg=jcfg, compute_dtype=jnp.float32,
                      fused_sandwich=False).mel_to_wav(mel)
    assert wav.shape == jwav.shape == (1, 12 * cfg.hop)
    np.testing.assert_allclose(wav, jwav, atol=2e-4, rtol=0)
