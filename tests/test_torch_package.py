"""Package hygiene of the port: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_oracle import one_thread  # noqa: E402,F401  (fixture)

# one torch thread a test process: the xdist workers' pools would
# oversubscribe the machine
pytestmark = pytest.mark.usefixtures("one_thread")

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


def test_linear_entry_points_default_to_the_card():
    """The linear controller, like the bilinear one, asks for CUDA unless
    the caller passes ``device="cpu"``."""
    from koopman_realizations_torch.config import MpcConfig
    from koopman_realizations_torch.control.kmpc import LinearKmpc
    from koopman_realizations_torch.utils.checkpoint import (
        LINEAR_MODEL,
        load_model,
    )

    model, scaler, _ = load_model(LINEAR_MODEL)
    cfg = MpcConfig(horizon=10, qp_iters=6, input_blocks=(1, 1, 2, 5),
                    input_bounds=(-2.7, 2.7), input_slopeConst=0.1,
                    proj_idx=(4, 5))
    if torch.cuda.is_available():
        assert LinearKmpc(model, scaler, cfg).A.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearKmpc(model, scaler, cfg)
    assert LinearKmpc(model, scaler, cfg, device="cpu").device.type == "cpu"


def test_linear_controller_refuses_what_is_not_ported():
    """Blocks with smoothness rows or state bounds (as in the JAX
    controller) and a bilinear model raise instead of running another
    controller; warm duals, the dual shift and the unblocked stack
    construct (their parity: ``tests/test_torch_knobs.py``)."""
    from koopman_realizations_torch.config import MpcConfig
    from koopman_realizations_torch.control.kmpc import LinearKmpc
    from koopman_realizations_torch.utils.checkpoint import (
        LINEAR_MODEL,
        load_model,
    )

    model, scaler, _ = load_model(LINEAR_MODEL)
    base = dict(horizon=10, qp_iters=6, input_blocks=(1, 1, 2, 5),
                input_bounds=(-2.7, 2.7), input_slopeConst=0.1,
                proj_idx=(4, 5))
    for extra in (dict(state_bounds=(-1.0, 1.0)),
                  dict(state_bounds=(-1.0, 1.0), qp_dual_warm=True),
                  dict(state_bounds=(-1.0, 1.0), qp_dual_shift=True),
                  dict(input_smoothConst=0.1)):
        with pytest.raises(NotImplementedError):
            LinearKmpc(model, scaler, MpcConfig(**{**base, **extra}),
                       device="cpu")
    for extra in (dict(qp_dual_warm=True), dict(qp_dual_shift=True),
                  dict(input_blocks=None)):
        LinearKmpc(model, scaler, MpcConfig(**{**base, **extra}),
                   device="cpu")
    with pytest.raises(NotImplementedError):
        LinearKmpc(load_model()[0], scaler, MpcConfig(**base), device="cpu")


def test_linear_cuda_wrappers_reject_host_tensors():
    """The new kernel wrappers take contiguous f32 CUDA tensors only, and
    say so before any build or launch."""
    from koopman_realizations_torch.config import MpcConfig
    from koopman_realizations_torch.control.kmpc import LinearKmpc
    from koopman_realizations_torch.ops.kernels.ipm_shared import (
        check_cuda_f32,
        ipm_shared_cuda,
    )
    from koopman_realizations_torch.utils.checkpoint import (
        LINEAR_MODEL,
        load_model,
    )

    model, scaler, _ = load_model(LINEAR_MODEL)
    mpc = LinearKmpc(model, scaler, MpcConfig(
        horizon=10, qp_iters=6, input_blocks=(1, 1, 2, 5),
        input_bounds=(-2.7, 2.7), input_slopeConst=0.1, proj_idx=(4, 5)),
        device="cpu")
    with pytest.raises(ValueError):
        check_cuda_f32(torch.zeros(3, 4))
    cons = mpc.constraints()
    q = torch.zeros(12, 4)
    with pytest.raises(ValueError):
        ipm_shared_cuda(cons, torch.eye(12), q, torch.ones(48, 4), q, 6,
                        1e-2)


def test_nonlinear_entry_points_default_to_the_card():
    """The NMPC controller, like the others, asks for CUDA unless the
    caller passes ``device="cpu"``, and its kernel wrapper takes
    contiguous f32 CUDA tensors only, saying so before any build or
    launch."""
    from koopman_realizations_torch.config import MpcConfig
    from koopman_realizations_torch.control.kmpc import NonlinearKmpc
    from koopman_realizations_torch.ops.kernels.nmpc_multipass import (
        nmpc_multipass_cuda,
    )
    from koopman_realizations_torch.utils.checkpoint import (
        NONLINEAR_MODEL,
        load_model,
    )

    model, scaler, _ = load_model(NONLINEAR_MODEL)
    cfg = MpcConfig(horizon=10, qp_iters=8, input_blocks=(1, 1, 2, 5),
                    input_bounds=(-2.7, 2.7), input_slopeConst=0.1,
                    proj_idx=(4, 5))
    if torch.cuda.is_available():
        assert NonlinearKmpc(model, scaler, cfg).G_t.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NonlinearKmpc(model, scaler, cfg)
    mpc = NonlinearKmpc(model, scaler, cfg, device="cpu")
    assert mpc.device.type == "cpu"
    qp = mpc.nmpc_qp()
    z = torch.zeros(6, 4)
    with pytest.raises(ValueError):
        nmpc_multipass_cuda(qp, z, torch.zeros(3, 4), torch.zeros(22), 5,
                            True, 8)


def test_sweep_entry_points_default_to_the_card():
    """The random-system ensemble, its model-class sweep and the
    closed-loop lasso sweep ask for CUDA unless the caller passes
    ``device="cpu"``."""
    import types

    import numpy as np

    from koopman_realizations_torch.config import ArmConfig, MpcConfig
    from koopman_realizations_torch.models.arm import Arm
    from koopman_realizations_torch.models.rsys import (
        construct_systems,
        simulate_systems,
    )
    from koopman_realizations_torch.utils.checkpoint import load_model
    from koopman_realizations_torch.workflows import evaluate_rand_models
    from koopman_realizations_torch.workflows.lasso_sweep import (
        lasso_sweep_closed_loop,
    )

    ens = construct_systems(2, 3, 2, 1, np.random.default_rng(0))
    sim = lambda **kw: simulate_systems(ens, 2.0, 0.5, 3,
                                        np.random.default_rng(0), **kw)
    model, scaler, _ = load_model()
    ks = types.SimpleNamespace(candidates=[model], scaler=scaler)
    cfg = MpcConfig(horizon=10, input_bounds=(-2.7, 2.7),
                    input_slopeConst=0.1, proj_idx=(4, 5))
    if torch.cuda.is_available():
        assert ens.vf(0, 0.5, 0.1).is_cuda
        return
    for call in (lambda: ens.vf(0, 0.5, 0.1), sim,
                 lambda: evaluate_rand_models(sim(device="cpu")),
                 lambda: lasso_sweep_closed_loop(
                     ks, Arm(ArmConfig(), device="cpu"), cfg,
                     np.zeros((3, 2)), steps=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    ds = sim(device="cpu")
    out = evaluate_rand_models(ds, 1, 1, 1, lasso_iters=5, device="cpu")
    assert set(out) == {"linear", "bilinear", "nonlinear"}
    assert ens.vf(0, 0.5, 0.1, device="cpu").device.type == "cpu"
