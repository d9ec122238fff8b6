"""The port's examples (``repro_torch.examples``: ``quickstart``,
``serve_lm``, ``train_lm``) run to their end on the CPU, each called
through its ``main`` as a user's command line would, and checked for its
completion string; and the launchers' ``--arch`` paths for the state
models (``launch.serve``, ``launch.train``) and for the two families the
engine does not serve.

The trainer's straggler check (the reference's: a step 1.5 times the
median for three polls evicts the host) reads the host's clock; on a
shared CPU a few slow steps stop a run early.  The training tests here
check the examples' arithmetic, so they run the trainer with that factor
at infinity (``steady_clock``); dead hosts are still detected.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.examples import quickstart, serve_lm, train_lm


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for this module: its problems are small, and
    under the suite's parallel workers every process's thread pool
    spanning all cores made them tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def steady_clock(monkeypatch):
    from repro_torch.train import trainer

    monkeypatch.setattr(trainer, "HeartbeatMonitor", functools.partial(
        HeartbeatMonitor, straggler_factor=float("inf")))


def test_quickstart_runs_to_done(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("done")
    for line in ("auto schedule matches oracle",
                 "custom strategy through the kernel: OK",
                 "planned 2-layer GCN matches the unfused spec: OK",
                 "distributed spmm matches oracle: OK"):
        assert line in out


def test_quickstart_holds_a_tuned_result_to_its_storage_tolerance():
    """An f32 pick is held at 1e-4; a narrow one at the reference's
    relative L2 for its storage type."""
    rng = np.random.default_rng(0)
    want = torch.tensor(rng.standard_normal((64, 4)), dtype=torch.float32)
    off = want * (1 + 1e-2)  # 1 % relative L2
    quickstart.check_tuned(want + 1e-6, want, None)
    quickstart.check_tuned(off, want, "bfloat16")
    with pytest.raises(AssertionError):
        quickstart.check_tuned(off, want, "float16")
    with pytest.raises(AssertionError):
        quickstart.check_tuned(off, want, "float32")


def test_serve_lm_serves_ten_requests(capsys):
    res = serve_lm.main(["--device", "cpu"])
    assert sorted(res) == list(range(10))
    assert "serve_lm complete" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-7b", "hymba-1.5b",
                                  "paligemma-3b"])
def test_train_lm_loss_falls(arch, capsys, tmp_path, steady_clock):
    losses = train_lm.main(["--arch", arch, "--device", "cpu", "--steps",
                            "12", "--batch", "2", "--seq", "32",
                            "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(losses).all()
    assert "train_lm complete" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_launchers_take_the_state_models(arch, tmp_path, steady_clock):
    from repro_torch.launch import serve, train

    res = serve.main(["--arch", arch, "--requests", "3", "--max-new", "4",
                      "--device", "cpu"])
    assert sorted(res) == [0, 1, 2] and all(len(v) == 4
                                            for v in res.values())
    trainer = train.main(["--arch", arch, "--steps", "3", "--batch", "2",
                          "--seq", "32", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu"])
    assert np.isfinite(trainer.losses()).all() and len(trainer.losses()) == 3


@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b"])
def test_serve_launcher_refuses_the_families_off_the_engine(arch):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="served through prefill and "
                                         "decode_step"):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_model_inputs_add_frames_and_patches_to_the_token_stream():
    """The encdec and vlm batches carry seeded frames or patches beside
    the stream's tokens, the same for the same seed; other families'
    batches are the tokens alone."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.data.synthetic import ModelInputs, ShardedTokenStream

    for arch, key, width in (("whisper-large-v3", "encoder_embeds", 24),
                             ("paligemma-3b", "patch_embeds", 8),
                             ("mamba2-2.7b", None, None)):
        cfg = smoke_config(ARCHS[arch])
        a, b = (next(ModelInputs(cfg, ShardedTokenStream(cfg.vocab_size, 16,
                                                         4, seed=1),
                                 seed=3)) for _ in range(2))
        want = next(ShardedTokenStream(cfg.vocab_size, 16, 4, seed=1))
        np.testing.assert_array_equal(a["tokens"], want["tokens"])
        assert sorted(a) == sorted(["tokens"] + ([key] if key else []))
        if key:
            assert a[key].shape == (4, width, cfg.d_model)
            assert a[key].dtype == np.float32
            np.testing.assert_array_equal(a[key], b[key])
