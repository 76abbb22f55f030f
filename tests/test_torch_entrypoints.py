"""The port's entry points and guards, on the CPU.

- ``cli sample`` (batched DDIM under CFG, single-clip DDPM) and ``cli towav``
  end to end with ``--device cpu``, through the same helpers ``chip_smoke.py``
  drives on the card, and the ``python -m lm2a_tpu_torch.cli`` dispatcher;
- the bf16 serving form on the CPU: kernel-layout weights keep their dtypes;
- ``chip_smoke.py``'s flagship geometry tables against the models themselves;
- guards: the package and ``chip_smoke.py`` import with jax blocked, no
  source imports ``lm2a_tpu``, entry points refuse to run without a card
  unless asked for the CPU, and ``chip_smoke.py`` fails without one.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from lm2a_tpu_torch.core.config import DiffusionConfig, LM2AConfig, ModelConfig
from lm2a_tpu_torch.inference.sample import load_models
from lm2a_tpu_torch.models.factory import build_denoiser
from lm2a_tpu_torch.vocoder.bigvgan import BIGVGAN_22KHZ_80BAND, BigVGANGenerator, SnakeAlias
from lm2a_tpu_torch.vocoder.vocode import Vocoder

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "lm2a_tpu_torch"
CFG = LM2AConfig(
    model=ModelConfig(base_dim=32, dim_mults=(1, 2), cond_dim=16, time_emb_dim=32,
                      num_res_blocks=1, mid_blocks=1, attn_heads=2),
    diffusion=DiffusionConfig(timesteps=12),
)
MEL_T = 24


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("entry")
    ckpt = chip_smoke.write_checkpoint(str(d / "ckpt"), CFG, seed=0)
    clips = chip_smoke.write_clips(str(d / "clips"), 2, seed=1, mel_t=MEL_T, motion_t=9)
    return d, ckpt, clips


def test_cli_sample_then_towav_batched(work):
    d, ckpt, clips = work
    gens, wavs, _, _ = chip_smoke.run_slice(ckpt, str(d / "clips"), str(d / "out"), "cpu",
                                            ddim_steps=4, preset="smoke_tiny")
    chip_smoke.check_outputs(gens, wavs, len(clips), MEL_T, hop=256)
    z = np.load(gens[0])
    assert z["motion"].shape == (MEL_T, 234) and z["lyrics"].shape == (MEL_T, 768)
    assert int(z["sr"]) == 22050 and int(z["hop_length"]) == 256


def test_cli_single_clip_ddpm_and_dispatcher(work, tmp_path):
    d, ckpt, clips = work
    from lm2a_tpu_torch.cli import sample as cli_sample

    cli_sample.main(["--npz", clips[0], "--ckpt", ckpt, "--out_dir", str(tmp_path),
                     "--method", "ddpm", "--guidance", "2.1", "--no_png", "--device", "cpu"])
    out = tmp_path / "clip_00_gen.npz"
    z = np.load(out)
    assert z["mel"].shape == (80, MEL_T) and np.isfinite(z["mel"]).all()
    assert z["motion_proj"].shape == (1, MEL_T, CFG.model.cond_dim)
    wav = tmp_path / "clip.wav"
    r = subprocess.run([sys.executable, "-m", "lm2a_tpu_torch.cli", "towav", "--npz", str(out),
                        "--out", str(wav), "--preset", "smoke_tiny", "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "random init" in r.stderr and wav.exists()


def test_bf16_serving_form_on_cpu(work):
    """load_models' default bf16: convs in bf16, GroupNorm and biases of the
    kernel-layout weights fp32 (what the CUDA wrappers require)."""
    _, ckpt, _ = work
    models = load_models(ckpt, device="cpu")
    for blk in models.denoiser.resblocks():
        p = blk.chain
        assert p.conv1_w.dtype == p.conv2_w.dtype == torch.bfloat16
        assert {v.dtype for v in (p.gn1_scale, p.gn1_bias, p.conv1_b, p.gn2_scale,
                                  p.gn2_bias, p.conv2_b)} == {torch.float32}
        assert blk.conv1.weight.dtype == torch.bfloat16
    x = torch.randn(2, MEL_T, 80)
    c = torch.randn(2, MEL_T, CFG.model.cond_dim)
    eps = models.denoiser(x, torch.tensor([3, 3]), c, c, uncond_rows=1)
    assert eps.dtype == torch.float32 and torch.isfinite(eps).all()


def test_chip_smoke_geometries_match_the_models():
    mc = ModelConfig()
    with torch.device("meta"):
        unet = build_denoiser(mc)
        gen = BigVGANGenerator(BIGVGAN_22KHZ_80BAND)
    geo = chip_smoke.resblock_geometries(mc, 516)
    blocks = unet.resblocks()
    assert len(geo) == len(blocks) == 15
    assert [(g[2], g[3], g[4], g[5]) for g in geo] == [
        (b.in_channels, b.out_channels, b.in_channels != b.out_channels, not b.use_attn)
        for b in blocks]
    assert [g[1] for g in geo] == [516, 516, 258, 258, 129, 129, 64, 64, 64,
                                   129, 129, 258, 258, 516, 516]
    sand = chip_smoke.sandwich_geometries(BIGVGAN_22KHZ_80BAND, 516)
    n_snake = sum(isinstance(m, SnakeAlias) for m in gen.modules())
    assert sum(u for *_, u in sand) == n_snake == 109
    assert sand[-1][1:3] == (256 * 516, 24)


# ---------------------------------------------------------------- guards

_BLOCKED = """
import importlib, pkgutil, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "flax", "optax", "orbax", "lm2a_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import lm2a_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lm2a_tpu_torch.__path__, "lm2a_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lm2a_tpu")]
print(len(names))
"""


def test_imports_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 30


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("lm2a_tpu", "jax", "jaxlib", "flax", "optax")]
    assert not bad


def test_entry_points_refuse_without_a_card(work, monkeypatch, tmp_path):
    _, ckpt, clips = work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from lm2a_tpu_torch.cli import sample as cli_sample
    from lm2a_tpu_torch.cli import towav as cli_towav

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_models(ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Vocoder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_sample.main(["--npz", clips[0], "--ckpt", ckpt, "--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_towav.main(["--npz", clips[0], "--preset", "smoke_tiny"])
    assert chip_smoke.main([]) == 1


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo it
    exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
