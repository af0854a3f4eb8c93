"""The PyTorch port stands alone: no JAX, flax or JAX-package import, and
its entry points default to CUDA (raising where there is none)."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddlexde_tpu_torch import (
    CubicHermiteSpline,
    ddeint,
    history_index,
    integrate_term,
    ode_term,
    resolve_device,
)
from paddlexde_tpu_torch.models.d3stn import D3STNConfig, Predictor, Trainer
from paddlexde_tpu_torch.ops.spline import hermite_gather_eval


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs 6 workers on 8 cores: torch's default of one compute
    thread per core in each worker (spinning between the tiny ops here)
    would take cores from the JAX tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "paddlexde_tpu", "paddlexde"}


def _port_sources():
    files = sorted((ROOT / "paddlexde_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_import_loads_no_jax():
    code = (
        "import sys, paddlexde_tpu_torch, paddlexde_tpu_torch.models.d3stn, "
        "paddlexde_tpu_torch.ops.spline, paddlexde_tpu_torch.ops.gcn, "
        "paddlexde_tpu_torch.ops.attn, paddlexde_tpu_torch.ops.timing, "
        "paddlexde_tpu_torch.models.d3stn.trainer, paddlexde_tpu_torch.models.d3stn.dataset, "
        "paddlexde_tpu_torch.models.d3stn.metrics, paddlexde_tpu_torch.models.d3stn.train_utils, "
        "paddlexde_tpu_torch.models.d3stn.weights\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def _tiny():
    cfg = D3STNConfig(num_nodes=4, his_len=16, tgt_len=12, encoder_num_layers=1,
                      decoder_num_layers=1, d_model=16, d_proj=8, d_sect=4,
                      d_adaptive=0, head=2, top_k=2)
    eye = np.eye(4, dtype=np.float32)
    lags = np.arange(12, dtype=np.float32)
    return cfg, lags, eye


def test_predictor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, lags, eye = _tiny()
    with pytest.raises(RuntimeError, match="CUDA device"):
        Predictor(cfg, None, lags, lags, eye, eye)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    pred = Predictor(cfg, None, lags, lags, eye, eye, device="cpu")
    assert pred.device == torch.device("cpu")


def test_trainer_defaults_to_cuda_and_refuses_a_mesh(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _, eye = _tiny()
    cfg.save_dir = str(tmp_path)
    data = np.random.RandomState(0).rand(288, 4, 1).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Trainer(cfg, data=data, adj_matrix=eye, sc_matrix=eye)
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(cfg, data=data, adj_matrix=eye, sc_matrix=eye, mesh=object(), device="cpu")
    assert Trainer(cfg, data=data, adj_matrix=eye, sc_matrix=eye, device="cpu").device.type == "cpu"


def _field(y_lags, y):
    return -y + y_lags.mean(dim=-2, keepdim=True)


_NUMPY_CALLS = {
    "history_index": lambda his, lags, y0: history_index(lags, his),
    "ddeint": lambda his, lags, y0: ddeint(_field, y0, [0.0, 1.0], lags, his, None),
    "integrate_term": lambda his, lags, y0: integrate_term(
        ode_term(lambda t, y: -y), y0, [0.0, 0.5, 1.0], "euler"),
    "CubicHermiteSpline": lambda his, lags, y0: CubicHermiteSpline(his).evaluate(lags),
    "hermite_gather_eval": lambda his, lags, y0: hermite_gather_eval(his, np.arange(16.0), lags),
}


@pytest.mark.parametrize("name", sorted(_NUMPY_CALLS))
def test_numpy_inputs_default_to_cuda(monkeypatch, name):
    """numpy data goes to the card (raising without one), never quietly to
    the CPU; CPU tensors are the explicit ask for the plain versions."""
    rng = np.random.RandomState(0)
    his, lags, y0 = rng.randn(2, 16, 3), np.array([1.5, 7.25, 14.0]), rng.randn(2, 1, 3)
    call = _NUMPY_CALLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        call(his, lags, y0)
    out = call(torch.tensor(his), torch.tensor(lags), torch.tensor(y0))
    out = out[0] if isinstance(out, tuple) else out
    assert out.device == torch.device("cpu") and torch.isfinite(out).all()
