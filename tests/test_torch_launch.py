"""The port's training launcher (``repro_torch.launch.train``) on a
one-rank gloo mesh: ``run`` (DTensor params, state and batches) against
a ``Trainer`` over the plain step, its resume from its checkpoints,
``main``'s refusal of the frontend-stub archs, and the distributed
substrate's modules free of JAX."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import TokenStream
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh, release_group
from repro_torch.models.transformer import DecoderLM
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")


@pytest.fixture
def host_mesh():
    """``make_host_mesh`` on the CPU: it starts the one-rank gloo group
    itself; the test tears it down."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    release_group()


def test_run_matches_a_plain_trainer(host_mesh, tmp_path, capsys):
    cfg = configs.get_smoke_config("llama3-8b")
    kw = dict(steps=3, batch=4, seq=16, lr=1e-3)
    res = launch_train.run(cfg, mesh=host_mesh, ckpt=str(tmp_path / "run"),
                           device="cpu", name="llama3-8b", **kw)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("llama3-8b on {'data': 1, 'model': 1}: loss ")
    assert "(resumed=False, stragglers=" in line

    model = DecoderLM(cfg, device="cpu")
    opt = make_optimizer("adamw", lr=kw["lr"],
                         state_dtype=cfg.opt_state_dtype)

    def init_state():
        params = model.init(0).stacked_params()
        return params, opt.init(params)

    ts = TokenStream(cfg.vocab_size, kw["seq"], kw["batch"], seed=0)
    want = Trainer(TrainerConfig(total_steps=kw["steps"] + 1,
                                 ckpt_dir=str(tmp_path / "plain")),
                   train_step=steps_mod.make_train_step(cfg, lr=kw["lr"]),
                   init_state=init_state, batch_fn=ts.batch,
                   device="cpu").run()
    assert res["losses"] == want["losses"][:kw["steps"]]
    assert len(res["losses"]) == kw["steps"]
    # a second run resumes from the last checkpoint and takes no step; a
    # third, one step further, restores the DTensors and takes the
    # uninterrupted run's next step
    again = launch_train.run(cfg, mesh=host_mesh, ckpt=str(tmp_path / "run"),
                             device="cpu", **kw)
    assert again["resumed"] and again["losses"] == []
    more = launch_train.run(cfg, mesh=host_mesh, ckpt=str(tmp_path / "run"),
                            device="cpu", **{**kw, "steps": kw["steps"] + 1})
    assert more["resumed"] and more["start_step"] == kw["steps"]
    assert more["losses"] == want["losses"][kw["steps"]:]


def test_meshes_refuse_a_group_of_the_wrong_size(host_mesh):
    from repro_torch.launch.mesh import make_production_mesh
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError):
        make_host_mesh(model_axis=3, device="cpu")


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_main_refuses_frontend_stub_archs(arch):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", arch, "--steps", "1"])
    assert not dist.is_initialized()


def test_distributed_modules_import_no_jax():
    mods = ["repro_torch.parallel", "repro_torch.parallel.sharding",
            "repro_torch.parallel.pipeline", "repro_torch.launch",
            "repro_torch.launch.mesh", "repro_torch.launch.train",
            "repro_torch.launch.steps", "repro_torch.optim",
            "repro_torch.optim.compression"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "clean", out.stdout + out.stderr
