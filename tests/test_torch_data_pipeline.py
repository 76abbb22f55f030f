"""The port's data pipeline against the JAX package's, on the CPU.

- ``make_dataset`` of both packages over one seeded raw tree
  (``chip_smoke.write_raw_tree``: 2 years, 3 songs of 20.5-40 s, lyric keys
  every 6 s and one that is not a time, SMPL frames at 30 fps with a gap
  held from the last frame and a song whose first frames are missing, zero
  filled; a short last slice where a song's audio ends) with
  ``HashedLyricsEmbedder``: every shard's keys but ``mel`` the same bits,
  ``mel`` within 1e-4 absolute of the JAX log-mel (the rule of
  ``tests/test_torch_eval.py``'s ``test_mel_spectrogram_matches``: fp32
  FFTs of two libraries), ``motion_stats.npz`` and
  ``sample_info_list.json`` equal;
- ``parse_time_key``, ``find_lyric_for_time``, ``extract_motion_track``;
- ``split_dataset``: the same three lists and manifests;
- ``HashedLyricsEmbedder`` bit for bit, ``get_lyrics_embedder("auto")``
  resolving as the JAX one does offline, ``tile_lyrics_embedding``;
- the three CLIs' flags and defaults against the JAX ones (``preprocess``
  adds ``--device``), ``inspect_npz`` printing the same lines, and ``cli
  preprocess`` -> ``split`` -> ``pack`` through the dispatcher;
- the new modules import with JAX blocked.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from lm2a_tpu.cli import inspect_npz as jax_cli_inspect
from lm2a_tpu.cli import preprocess as jax_cli_preprocess
from lm2a_tpu.cli import split as jax_cli_split
from lm2a_tpu.data import lyrics as jlyrics
from lm2a_tpu.data import preprocess as jpre
from lm2a_tpu.data import split as jsplit
from lm2a_tpu_torch.cli import __main__ as cli_main
from lm2a_tpu_torch.cli import inspect_npz as cli_inspect
from lm2a_tpu_torch.cli import preprocess as cli_preprocess
from lm2a_tpu_torch.cli import split as cli_split
from lm2a_tpu_torch.data import lyrics
from lm2a_tpu_torch.data import preprocess as pre
from lm2a_tpu_torch.data import split

from _torch_port_util import one_torch_thread  # noqa: F401

MEL_ATOL = 1e-4


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The raw tree, and the shards of both packages built from it."""
    root = tmp_path_factory.mktemp("pipeline")
    raw = chip_smoke.write_raw_tree(str(root / "raw"), seed=0)
    n_port = pre.make_dataset(raw, str(root / "port"), lyrics_backend="hashed", device="cpu")
    n_jax = jpre.make_dataset(raw, str(root / "jax"), lyrics_backend="hashed")
    return root, raw, n_port, n_jax


def test_shards_match_the_jax_package(built):
    root, _, n_port, n_jax = built
    assert n_port == n_jax == 17
    names = sorted(os.listdir(root / "jax"))
    assert sorted(os.listdir(root / "port")) == names
    for name in names:
        if not (name.startswith("sample_") and name.endswith(".npz")):
            continue
        got, want = (np.load(root / d / name, allow_pickle=True) for d in ("port", "jax"))
        assert got.files == want.files and len(got.files) == 11
        for key in want.files:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
            if key == "mel":
                np.testing.assert_allclose(got[key], want[key], atol=MEL_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    for key in ("mean", "std"):
        np.testing.assert_array_equal(np.load(root / "port" / "motion_stats.npz")[key],
                                      np.load(root / "jax" / "motion_stats.npz")[key])
    info = [json.load(open(root / d / "sample_info_list.json")) for d in ("port", "jax")]
    assert info[0] == info[1] and len(info[0]) == 17


def test_shards_hold_the_slices_the_tree_gives(built):
    """Full slices are (80, 516); the short last slice of a song has fewer
    frames; motion and lyrics are 180 frames."""
    root = built[0]
    info = json.load(open(root / "port" / "sample_info_list.json"))
    shapes = {tuple(i["mel_shape"]) for i in info}
    assert (80, 516) in shapes and any(s[1] < 516 for s in shapes)
    assert {tuple(i["motion_shape"]) for i in info} == {(180, 234)}
    assert all(i["lyric_text"] for i in info)


@pytest.mark.parametrize("key", ["0:06", "1:30", "12.5", "", "intro", "1:2:3"])
def test_parse_time_key(key):
    assert pre.parse_time_key(key) == jpre.parse_time_key(key)


def test_lyric_lookup_and_motion_track(built):
    raw = built[1]
    song = os.path.join(raw, "2019", "song_b")
    sliced = json.load(open(os.path.join(song, "sliced.json")))
    smpl = json.load(open(os.path.join(song, "smplfull.json")))
    for t in (0.0, 6.0, 5.9995, 7.0, 100.0):
        assert pre.find_lyric_for_time(sliced, t) == jpre.find_lyric_for_time(sliced, t)
    for start in (0, 5, 300, 900):  # zero fill before frame 10, the held gap
        got = pre.extract_motion_track(smpl, start, 180)
        np.testing.assert_array_equal(got, jpre.extract_motion_track(smpl, start, 180))
    assert not pre.extract_motion_track(smpl, 0, 180)[:10].any()


def test_split_gives_the_same_lists(built, tmp_path):
    src = str(built[0] / "port")
    for kw in (dict(), dict(counts=(9, 5, 3)), dict(seed=7, train_ratio=0.5, val_ratio=0.3,
                                                    test_ratio=0.2)):
        tag = str(len(os.listdir(tmp_path)))
        got = split.split_dataset(src, str(tmp_path / f"p{tag}"), **kw)
        want = jsplit.split_dataset(src, str(tmp_path / f"j{tag}"), **kw)
        for part in ("train", "val", "test"):
            assert getattr(got, part) == getattr(want, part)
            assert (open(tmp_path / f"p{tag}" / f"{part}.txt").read()
                    == open(tmp_path / f"j{tag}" / f"{part}.txt").read())
            assert (sorted(os.listdir(tmp_path / f"p{tag}" / part))
                    == sorted(os.path.basename(p) for p in getattr(got, part)))
    with pytest.raises(ValueError, match="ratios"):
        split.split_dataset(src, str(tmp_path / "bad"), 0.5, 0.2, 0.2)


def test_hashed_embedder_and_tiling():
    texts = ["dance night light", "", "Hello, World! hello", "x " * 300, "ünïcode words"]
    got, want = lyrics.HashedLyricsEmbedder(), jlyrics.HashedLyricsEmbedder()
    for t in texts:
        e = got.embed(t)
        assert e.dtype == np.float32 and e.shape == (lyrics.EMBED_DIM,)
        np.testing.assert_array_equal(e, want.embed(t))
    e = got.embed(texts[0])
    np.testing.assert_array_equal(lyrics.tile_lyrics_embedding(e, 516),
                                  jlyrics.tile_lyrics_embedding(e, 516))


def test_auto_embedder_resolves_as_the_jax_one(monkeypatch):
    monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)
    got = lyrics.get_lyrics_embedder("auto", device="cpu")
    assert "HF_HUB_OFFLINE" not in os.environ  # set only while resolving
    want = jlyrics.get_lyrics_embedder("auto")
    assert type(got).__name__ == type(want).__name__
    assert isinstance(lyrics.get_lyrics_embedder("hashed"), lyrics.HashedLyricsEmbedder)
    with pytest.raises(ValueError, match="unknown lyrics backend"):
        lyrics.get_lyrics_embedder("bert")


def _defaults(parser, argv):
    return vars(parser.parse_args(argv))


def test_cli_flags_and_defaults_match_the_jax_clis():
    req = ["--root", "r", "--out", "o"]
    got = _defaults(cli_preprocess.build_parser(), req)
    assert got.pop("device") == "cuda"
    assert got == _defaults(jax_cli_preprocess.build_parser(), req)
    req = ["--npz_dir", "n", "--out_dir", "o"]
    assert _defaults(cli_split.build_parser(), req) == _defaults(jax_cli_split.build_parser(), req)
    assert (_defaults(cli_inspect.build_parser(), ["x.npz"])
            == _defaults(jax_cli_inspect.build_parser(), ["x.npz"]))
    for cmd in ("preprocess", "split", "inspect_npz"):
        assert cmd in cli_main.COMMANDS


def test_inspect_npz_prints_the_same_lines(built, capsys, tmp_path):
    shard = str(built[0] / "port" / "sample_00000000.npz")
    cli_inspect.main([shard])
    got = capsys.readouterr().out
    jax_cli_inspect.main([shard])
    assert got == capsys.readouterr().out
    assert "mel: shape=(80, 516)" in got and "mel fps: 86.13" in got
    pytest.importorskip("matplotlib")
    cli_inspect.main([shard, "--plot", str(tmp_path / "mel.png")])
    assert os.path.getsize(tmp_path / "mel.png") > 0


def test_cli_preprocess_split_pack_through_the_dispatcher(tmp_path, monkeypatch, capsys):
    raw = chip_smoke.write_raw_tree(str(tmp_path / "raw"), seed=1,
                                    songs=(("2021", "only", 19.0, 0),))
    for argv in (["preprocess", "--root", raw, "--out", str(tmp_path / "npz"),
                  "--lyrics_backend", "hashed", "--device", "cpu"],
                 ["split", "--npz_dir", str(tmp_path / "npz"), "--out_dir",
                  str(tmp_path / "split"), "--train_count", "2", "--val_count", "1",
                  "--test_count", "1"],
                 ["pack", "--npz_dir", str(tmp_path / "split" / "train"), "--out_dir",
                  str(tmp_path / "pack")]):
        monkeypatch.setattr(sys, "argv", ["lm2a_tpu_torch.cli", *argv])
        cli_main.main()
    out = capsys.readouterr().out
    assert "wrote samples: 4" in out and "Train set: 2 (50.0%)" in out
    meta = json.load(open(tmp_path / "pack" / "pack_meta.json"))
    assert meta["num_samples"] == 2


NEW_MODULES = [
    "lm2a_tpu_torch.ops.motion", "lm2a_tpu_torch.data", "lm2a_tpu_torch.data.lyrics",
    "lm2a_tpu_torch.data.split", "lm2a_tpu_torch.data.preprocess",
    "lm2a_tpu_torch.data.native_loader", "lm2a_tpu_torch.cli.preprocess",
    "lm2a_tpu_torch.cli.split", "lm2a_tpu_torch.cli.inspect_npz",
]


def test_new_modules_import_without_jax():
    """This slice's data modules import with JAX and the JAX package blocked
    (the guard script of ``tests/test_torch_eval.py``)."""
    from test_torch_eval import _BLOCKED

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _BLOCKED, *NEW_MODULES], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", str(len(NEW_MODULES))]
