"""Package hygiene of the port: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "koopman_realizations_torch"
FORBIDDEN = ("jax", "jaxlib", "koopman_realizations_tpu")


def _port_modules():
    """The port's Python files (not its build outputs)."""
    build = PORT / "build"
    return sorted(p for p in PORT.rglob("*.py") if build not in p.parents)


def _port_sources():
    return _port_modules() + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_import_anywhere_in_the_port():
    files = _port_sources()
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), r) for p in files
           for r in _imported_roots(p) if r in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    """Every module of the port (and chip_smoke) imports in a process where
    importing jax or the JAX package raises."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            .replace(".__init__", "") for p in _port_modules()]
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card():
    """Without ``device=`` the entry points ask for CUDA: on a box without
    it they raise instead of moving to the CPU."""
    from koopman_realizations_torch.config import ArmConfig, MpcConfig
    from koopman_realizations_torch.control.kmpc import BilinearKmpc
    from koopman_realizations_torch.control.ksim import Ksim
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.utils.checkpoint import load_model

    model, scaler, _ = load_model()
    cfg = MpcConfig(horizon=10, qp_iters=4, qp_dual_warm=True,
                    input_blocks=(1, 1, 2, 5), input_bounds=(-2.7, 2.7),
                    input_slopeConst=0.1, proj_idx=(4, 5))
    if torch.cuda.is_available():
        assert BilinearKmpc(model, scaler, cfg).gens.is_cuda
        assert Arm(ArmConfig()).G.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BilinearKmpc(model, scaler, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Arm(ArmConfig())
    # asked for explicitly, the CPU path is there
    mpc = BilinearKmpc(model, scaler, cfg, device="cpu")
    arm = Arm(ArmConfig(), device="cpu")
    assert not mpc.gens.is_cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Ksim(arm, mpc)
    assert Ksim(arm, mpc, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without CUDA, and
    in a directory that holds nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_cuda_wrappers_reject_wrong_operands():
    """The kernel wrappers validate dtype and device before any launch."""
    from koopman_realizations_torch.config import MpcConfig
    from koopman_realizations_torch.control.kmpc import BilinearKmpc
    from koopman_realizations_torch.ops.kernels.bilin_lift import (
        check_operands,
    )
    from koopman_realizations_torch.utils.checkpoint import load_model

    model, scaler, _ = load_model()
    mpc = BilinearKmpc(model, scaler, MpcConfig(
        horizon=10, qp_iters=4, input_blocks=(1, 1, 2, 5),
        input_bounds=(-2.7, 2.7), input_slopeConst=0.1, proj_idx=(4, 5)),
        device="cpu")
    qp = mpc.lift_qp()
    check_operands(qp, torch.zeros(3, 4))
    with pytest.raises(ValueError):
        check_operands(qp, torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        check_operands(qp, torch.zeros(4, 3).T)
