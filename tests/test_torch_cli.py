"""The port's command line (python -m volq_torch.cli) on the CPU: the
cases of tests/test_cli.py with ``--device cpu`` and the same shrunk c1,
plus what the port adds (``--device``, ``--mesh`` refused) and the first
frame of c1 through both packages' CLIs (within 1e-5: XLA's jit contracts
multiply-adds, the port rounds op by op)."""
import json

import numpy as np
import pytest
import torch

from volq.cli import main as jax_main
from volq_torch.cli import main

_SHRINK = ["--set", "render.width=128", "--set", "render.height=64",
           "--set", "render.steps=8", "--set", "volume.size=16",
           "--set", "n_particles=8", "--set", "init=grid",
           "--set", "emitter.size_min=0.4", "--set", "emitter.size_max=0.7"]
_CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These scenes are small: one intra-op thread is as fast, and does not
    fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_frames_per_launch(tmp_path):
    """The saved (every Nth) frames of a batched run equal the
    one-frame-per-launch run's; a remainder launch is the last one."""
    out1, outn, outr = tmp_path / "one", tmp_path / "batched", tmp_path / "r"
    main(["--preset", "c1", "--frames", "4", "--out", str(out1), "--npy"]
         + _SHRINK + _CPU)
    rc = main(["--preset", "c1", "--frames", "4", "--frames-per-launch",
               "2", "--out", str(outn), "--npy"] + _SHRINK + _CPU)
    assert rc == 0
    a = np.load(out1 / "frame_0003.npy")   # 4th frame
    b = np.load(outn / "frame_0001.npy")   # 2nd launch = frames 3-4
    assert np.array_equal(a, b)
    assert not (outn / "frame_0002.npy").exists()
    main(["--preset", "c1", "--frames", "4", "--frames-per-launch", "3",
          "--out", str(outr), "--npy"] + _SHRINK + _CPU)
    assert np.array_equal(a, np.load(outr / "frame_0001.npy"))
    assert np.array_equal(np.load(out1 / "frame_0002.npy"),
                          np.load(outr / "frame_0000.npy"))


def test_cli_warp_engine(tmp_path):
    """The reference's flags (tests/test_cli.py): c1's ortho camera under
    the warp engine's default XLA path; the frame equals volq.cli's
    within 1e-5 (fp32)."""
    out, ref = tmp_path / "warp", tmp_path / "jax"
    flags = ["--preset", "c1", "--frames", "1", "--npy",
             "--set", "render.engine=warp",
             "--set", "render.warp_rect=96"] + _SHRINK
    rc = main(flags + ["--out", str(out)] + _CPU)
    assert rc == 0
    a = np.load(out / "frame_0000.npy")
    assert a.shape == (64, 128, 4) and a[..., 3].max() > 0.05
    assert jax_main(flags + ["--out", str(ref)]) == 0
    assert np.abs(a - np.load(ref / "frame_0000.npy")).max() <= 1e-5


@pytest.mark.parametrize("preset", ["c1", "c2", "c3", "c4", "c5"])
def test_cli_dump_config(capsys, preset):
    assert main(["--preset", preset, "--dump-config"]) == 0
    got = capsys.readouterr().out
    assert jax_main(["--preset", preset, "--dump-config"]) == 0
    assert got == capsys.readouterr().out
    assert json.loads(got)["n_particles"] == \
        {"c1": 1, "c2": 64, "c3": 1024, "c4": 4096, "c5": 16384}[preset]


def test_cli_config_file_and_set(tmp_path, capsys):
    main(["--preset", "c1", "--dump-config"] + _SHRINK)
    path = tmp_path / "cfg.json"
    path.write_text(capsys.readouterr().out)
    main(["--config", str(path), "--set", "render.background=[0.1,0.2,0.3]",
          "--dump-config"])
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["render"]["width"] == 128
    assert cfg["render"]["background"] == [0.1, 0.2, 0.3]
    with pytest.raises(SystemExit):
        main(["--dump-config"])


def test_cli_gif_captures_every_frame(tmp_path, capsys):
    """--gif with --frames-per-launch > 1 forces one frame per launch
    (with a note), so the GIF gets all --frames frames.  The camera
    orbits so that frames differ (PIL merges identical ones)."""
    gif = tmp_path / "anim.gif"
    rc = main(["--preset", "c1", "--frames", "3", "--frames-per-launch",
               "2", "--gif", str(gif), "--gif-width", "64", "--orbit",
               "90", "--out", str(tmp_path / "g")] + _SHRINK + _CPU)
    assert rc == 0
    assert "forcing --frames-per-launch 1" in capsys.readouterr().err
    from PIL import Image
    with Image.open(gif) as im:
        assert getattr(im, "n_frames", 1) == 3 and im.size[0] == 64
    assert not (tmp_path / "g" / "frame_0000.png").exists()


def test_cli_camera_path(tmp_path):
    """--dolly / --orbit move the image over the run; without them the
    static scene's frames are equal."""
    out = tmp_path / "fly"
    rc = main(["--preset", "c1", "--frames", "3", "--dolly", "0.5",
               "--orbit", "60", "--out", str(out), "--npy"]
              + _SHRINK + _CPU)
    assert rc == 0
    a = np.load(out / "frame_0000.npy")
    b = np.load(out / "frame_0002.npy")
    assert a[..., 3].max() > 0.05
    assert np.abs(a - b).max() > 1e-3
    out2 = tmp_path / "static"
    main(["--preset", "c1", "--frames", "2", "--out", str(out2),
          "--npy"] + _SHRINK + _CPU)
    assert np.array_equal(np.load(out2 / "frame_0000.npy"),
                          np.load(out2 / "frame_0001.npy"))


_EMIT = ["--set", "emitter.rate=200.0", "--set", "emitter.life_min=0.3",
         "--set", "emitter.life_max=0.6", "--set", "emitter.radius=1.0",
         "--set", "emitter.vel_base=[1.5,0.5,0.0]"]


def test_cli_checkpoint_then_resume(tmp_path):
    """2 frames + checkpoint, then --resume for 1 more: the frame of an
    uninterrupted 3-frame run.  The checkpoint's config wins over
    --preset; PNG is the default output."""
    ck = tmp_path / "ck.npz"
    full, part, rest = tmp_path / "full", tmp_path / "part", tmp_path / "rest"
    main(["--preset", "c1", "--frames", "3", "--out", str(full), "--npy"]
         + _SHRINK + _EMIT + _CPU)
    main(["--preset", "c1", "--frames", "2", "--out", str(part), "--npy",
          "--png", "--checkpoint", str(ck)] + _SHRINK + _EMIT + _CPU)
    assert (part / "frame_0001.png").read_bytes()[:4] == b"\x89PNG"
    rc = main(["--resume", str(ck), "--preset", "c2", "--frames", "1",
               "--out", str(rest), "--npy"] + _CPU)
    assert rc == 0
    a = np.load(full / "frame_0002.npy")
    assert a[..., 3].max() > 0.01
    assert np.array_equal(a, np.load(rest / "frame_0000.npy"))
    assert not np.array_equal(a, np.load(full / "frame_0000.npy"))
    main(["--resume", str(ck), "--preset", "c1", "--frames", "1", "--out",
          str(tmp_path / "dflt")] + _CPU)
    assert (tmp_path / "dflt" / "frame_0000.png").exists()


def test_cli_warmup_steps_the_sim(tmp_path):
    """--warmup is parsed and ignored, as volq.cli does: --warmup 2 gives
    the frames of --warmup 0 (engine.loop.run(warmup=) does step the
    sim: test_loop_run_warmup_steps_the_sim)."""
    a, b = tmp_path / "a", tmp_path / "b"
    main(["--preset", "c1", "--frames", "2", "--out", str(a), "--npy"]
         + _SHRINK + _EMIT + _CPU)
    main(["--preset", "c1", "--frames", "2", "--warmup", "2", "--out",
          str(b), "--npy"] + _SHRINK + _EMIT + _CPU)
    for f in ("frame_0000.npy", "frame_0001.npy"):
        assert np.array_equal(np.load(a / f), np.load(b / f))
    assert not np.array_equal(np.load(a / "frame_0000.npy"),
                              np.load(a / "frame_0001.npy"))


def test_loop_run_warmup_steps_the_sim():
    """engine.loop.run keeps its warmup: that many un-rendered sim steps
    before the first frame."""
    from volq_torch.cli import _apply_override
    from volq_torch.engine import loop
    from volq_torch.scene.config import c1
    cfg = c1()
    flags = (_SHRINK + _EMIT)[1::2]
    for kv in flags:
        cfg = _apply_override(cfg, kv)
    _, full, _ = loop.run(cfg, 3, device="cpu")
    _, warm, _ = loop.run(cfg, 1, warmup=2, device="cpu")
    assert np.array_equal(full[2], warm[0])
    assert not np.array_equal(full[0], warm[0])


def test_cli_bench_prints_one_json_line(capsys):
    rc = main(["--preset", "c1", "--bench", "--frames", "1",
               "--frames-per-launch", "2", "--set", "render.max_pairs=64"]
              + _SHRINK + _CPU)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"frame_ms", "fps", "mrays_per_s",
                        "frames_per_launch", "mesh", "stats"}
    # 8192 rays a frame: the rate, rounded to 0.1 Mrays/s, may read 0.0
    assert rec["frame_ms"] > 0 and rec["fps"] > 0 and rec["mrays_per_s"] >= 0
    assert abs(rec["fps"] - 1e3 / rec["frame_ms"]) <= 0.06 + 1e-3 * rec["fps"]
    assert rec["frames_per_launch"] == 2 and rec["mesh"] == 0
    assert rec["stats"]["alive"] == 8 and rec["stats"]["pairs_kept"] > 0


def test_cli_mesh_and_missing_card_raise(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        main(["--preset", "c1", "--frames", "1", "--mesh", "8", "--out",
              str(tmp_path / "m")] + _SHRINK + _CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        main(["--preset", "c1", "--bench", "--mesh", "8"] + _SHRINK + _CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        main(["--preset", "c1", "--set", "render.engine=slab", "--out",
              str(tmp_path / "s")] + _SHRINK + _CPU)
    # without --device cpu and without a card nothing carries on
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--bench"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--preset", "c1", "--frames", "1", "--out",
                  str(tmp_path / "n")] + extra + _SHRINK)


def test_cli_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    rc = main(["--preset", "c1", "--frames", "1", "--out",
               str(tmp_path / "o"), "--npy", "--profile", str(prof)]
              + _SHRINK + _CPU)
    assert rc == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 0


def test_cli_c1_first_frame_matches_reference(tmp_path):
    """Preset c1 (shrunk as above, still ortho and single-volume) through
    both command lines."""
    shrink = ["--set", "render.width=128", "--set", "render.height=64",
              "--set", "render.steps=8", "--set", "volume.size=16"]
    j, t = tmp_path / "jax", tmp_path / "torch"
    assert jax_main(["--preset", "c1", "--frames", "1", "--out", str(j),
                     "--npy"] + shrink) == 0
    assert main(["--preset", "c1", "--frames", "1", "--out", str(t),
                 "--npy"] + shrink + _CPU) == 0
    a, b = np.load(j / "frame_0000.npy"), np.load(t / "frame_0000.npy")
    assert a.shape == b.shape == (64, 128, 4) and a[..., 3].max() > 0.1
    assert np.abs(a - b).max() <= 1e-5
