"""The port stands alone, and its entry points never fall back silently.

* ``paddle_tpu_torch`` (every module), ``chip_smoke``,
  ``profile_serving`` and ``tune_flash_bwd`` import in a process where
  importing ``jax`` or ``paddle_tpu`` raises.
* Without CUDA, an entry point raises unless the caller asks for the
  CPU by name (``device="cpu"``, ``fluid.CPUPlace()``); ``chip_smoke.py`` exits non-zero and prints no result,
  also when it sits in a directory without the rest of the repo.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import fluid, resolve_device
from paddle_tpu_torch.serving import PagedTransformerGenerator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import profile_serving
import tune_flash_bwd
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print(" ".join(names))
"""


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


# the modules of the LSTM slice, among those imported
SLICE_3 = {"paddle_tpu_torch.fluid.core.lod",
           "paddle_tpu_torch.fluid.ops.rnn_ops",
           "paddle_tpu_torch.fluid.ops.sequence_ops",
           "paddle_tpu_torch.fluid.layers.recurrent",
           "paddle_tpu_torch.fluid.layers.sequence",
           "paddle_tpu_torch.kernels.lstm",
           "paddle_tpu_torch.models.sentiment"}


# the modules of the book's first two chapters and the bf16 recipe
BOOK = {"paddle_tpu_torch.fluid.nets",
        "paddle_tpu_torch.fluid.layers.tensor",
        "paddle_tpu_torch.models.fit_a_line",
        "paddle_tpu_torch.models.recognize_digits"}


def test_port_imports_without_jax_or_reference():
    out = _run(["-c", _ISOLATED], cwd=ROOT)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 50                   # every module was imported
    assert SLICE_3 | BOOK <= names, (SLICE_3 | BOOK) - names


def test_entry_points_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedTransformerGenerator(24, 24, n_layer=1, n_head=2, d_key=4,
                                  d_value=4, d_model=8, d_inner_hid=8,
                                  max_length=16, src_len=8, max_out_len=4,
                                  page_size=4, num_pages=8)
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction is False
    with pytest.raises(NotImplementedError, match="beam"):
        PagedTransformerGenerator(24, 24, device="cpu", topk_size=4)


def test_executor_runs_on_the_card_unless_given_cpu_place(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (fluid.Executor, lambda: fluid.Executor(fluid.CUDAPlace(0)),
                 lambda: fluid.scope_from_numpy({"w": [1.0]})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(TypeError, match="CUDAPlace or CPUPlace"):
        fluid.Executor("cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    assert exe.device == torch.device("cpu")
    scope = fluid.scope_from_numpy({"w": [1.0]}, fluid.CPUPlace())
    assert scope.find_var("w").device == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    out = _run(["chip_smoke.py"], cwd=cwd, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
