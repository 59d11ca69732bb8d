"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and the LM
stack imports and serves on the CPU in a process where neither can be
imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, REPO) for f in FILES])
def test_no_jax_and_no_reference_package(path):
    for name in _imported(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (
            f"{path.relative_to(REPO)} imports {name}")


LM_MODULES = ["configs.lm_archs", "configs.registry", "configs.shapes",
              "models.layers", "models.attention", "models.ssm",
              "models.transformer", "serve.engine", "launch.serve",
              "kernels.flash_attention.ops", "kernels.rwkv_scan.ops",
              "bridge"]


def test_lm_stack_runs_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {LM_MODULES!r}:\n"
        "    importlib.import_module('repro_torch.' + m)\n"
        "from repro_torch.launch.serve import main\n"
        "main(['--device', 'cpu', '--arch', 'rwkv6-7b', '--requests', '2',"
        " '--prompt-len', '5', '--gen', '2'])\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro') for k in "
        "sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve]" in out.stdout


RESILIENCE_MODULES = ["camera.offload", "camera.offload.resilience",
                      "camera.offload.link", "camera.offload.controller",
                      "ckpt.checkpoint", "obs", "obs.ledger",
                      "obs.telemetry"]


def test_resilience_layer_runs_without_jax(tmp_path):
    """The resilience layer imports, and a session under burst loss with
    a brownout checkpoints, restores and delivers on the CPU, in a process
    where neither JAX nor the reference package can be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {RESILIENCE_MODULES!r}:\n"
        "    importlib.import_module('repro_torch.' + m)\n"
        "import numpy as np\n"
        "from repro_torch.camera.bssa import GridSpec\n"
        "from repro_torch.camera.offload import (BrownoutModel,\n"
        "    FaultInjector, GilbertElliott, OffloadSession,\n"
        "    VROffloadExecutor)\n"
        "from repro_torch.camera.pipelines import VRRigExecutor\n"
        "rng = np.random.default_rng(0)\n"
        "v = rng.random((2, 2, 24, 32)).astype(np.float32)\n"
        "rig = VRRigExecutor(GridSpec(8), max_disp=4, n_iters=2,\n"
        "                    device='cpu')\n"
        "off = VROffloadExecutor(rig, 'stitch', bits=8)\n"
        "want, _ = off(v[0], v[1])\n"
        "inj = FaultInjector(loss=GilbertElliott(0.3, 0.5), seed=1,\n"
        "    brownout=BrownoutModel(storage_j=9e-6, jitter=0.0))\n"
        f"s = OffloadSession(off, injector=inj, ckpt_dir={str(tmp_path)!r})\n"
        "got, rec = s.send(v[0], v[1])\n"
        "assert rec.delivered and rec.restores >= 1, rec\n"
        "assert all((a == b).all() for a, b in zip(got, want))\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro') for k in "
        "sys.modules)\n"
        "print('[resilience] ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[resilience] ok" in out.stdout


TRAIN_MODULES = ["data.pipeline", "train.optimizer", "train.step",
                 "train.loop", "launch.train", "ckpt.checkpoint", "bridge"]


def test_lm_training_runs_without_jax(tmp_path):
    """The training slice imports, and the training CLI trains, checkpoints
    and finishes on the CPU, in a process where neither JAX nor the
    reference package can be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {TRAIN_MODULES!r}:\n"
        "    importlib.import_module('repro_torch.' + m)\n"
        "from repro_torch.launch.train import main\n"
        "out = main(['--device', 'cpu', '--arch', 'rwkv6-7b', '--steps', '3',"
        " '--global-batch', '2', '--seq', '12', '--ckpt-every', '2',"
        f" '--ckpt-dir', {str(tmp_path)!r}])\n"
        "assert [h['step'] for h in out['history']] == [0, 1, 2]\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro') for k in "
        "sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train]" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
