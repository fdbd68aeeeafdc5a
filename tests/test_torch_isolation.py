"""Isolation and device rules of the PyTorch port.

- No module of ``triton_dist_tpu_torch`` and not ``chip_smoke.py``
  imports ``jax``, ``jaxlib`` or the JAX package (checked on the source
  with ``ast``, so a lazy import inside a function counts too; one case
  per subpackage, naming the offending files).
- Entry points run on the card by default: without CUDA, ``Engine``
  called without ``device="cpu"`` raises.
- The kernel wrappers take their plain version for a CPU tensor and for
  nothing else: a tensor elsewhere goes to the kernel path, which raises
  here instead of computing quietly."""

import ast
import pathlib

import pytest
import torch

import triton_dist_tpu_torch
from triton_dist_tpu_torch.models import Engine, ModelConfig
from triton_dist_tpu_torch.ops import paged_flash_decode as pfd
from triton_dist_tpu_torch.ops import paged_flash_qblock as pfq

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "triton_dist_tpu")


def _groups():
    """The sources by the port's subpackage (``lang``, ``layers``, ...),
    then the package's ``__init__.py`` and ``chip_smoke.py``: one test case
    each, so a new module joins its subpackage's case instead of adding
    one."""
    pkg = pathlib.Path(triton_dist_tpu_torch.__file__).parent
    groups = {sub.name: sorted(sub.rglob("*.py"))
              for sub in sorted(pkg.iterdir())
              if sub.is_dir() and (sub / "__init__.py").exists()}
    groups["__init__.py"] = [pkg / "__init__.py"]
    groups["chip_smoke.py"] = [ROOT / "chip_smoke.py"]
    return groups


def _sources():
    files = [f for group in _groups().values() for f in group]
    assert len(files) > 10 and files[-1].exists()
    return files


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("group", list(_groups()))
def test_no_jax_imports(group):
    """Every file of ``group`` is parsed; the message names each file that
    imports a forbidden module."""
    files = _groups()[group]
    assert files and all(f.exists() for f in files)
    bad = {}
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        found = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
        if found:
            bad[str(path.relative_to(ROOT))] = found
    assert not bad, f"{group}: {bad}"


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(ModelConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(ModelConfig.tiny(), device="cuda")
    Engine(ModelConfig.tiny(), device="cpu", dtype=torch.float32)


def test_moe_modules_are_checked_and_need_cuda():
    """The MoE slice's modules are among the sources checked above, and
    its entry points (both lanes) raise without a card unless given
    ``device="cpu"``."""
    from triton_dist_tpu_torch.megakernel import MegaKernelEngine

    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("layers/ep_moe.py", "layers/tp_moe.py", "ops/group_gemm.py",
                "models/qwen_moe.py"):
        assert f"triton_dist_tpu_torch/{mod}" in names
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = ModelConfig.tiny_moe(num_experts=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MegaKernelEngine(cfg, batch=2, max_len=16, tile_w=16, t_tile=8)
    Engine(cfg, device="cpu", dtype=torch.float32)


def test_dense_cache_slice_modules_are_checked():
    """The dense-cache engine slice's modules are among the sources
    checked above; its entry points need the card unless given
    ``device="cpu"``."""
    from triton_dist_tpu_torch.models.hf_loader import (
        load_hf_checkpoint, moe_params_from_hf_state_dict,
        params_from_hf_state_dict)

    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("models/kv_cache.py", "models/hf_loader.py",
                "ops/flash_attention.py", "ops/ag_moe.py",
                "ops/moe_reduce.py"):
        assert f"triton_dist_tpu_torch/{mod}" in names
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_hf_checkpoint(str(ROOT / "tests" / "fixtures" / "qwen3_tiny"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(ModelConfig.tiny(), mode="fused")
    for mapper, cfg in ((params_from_hf_state_dict, ModelConfig.tiny()),
                        (moe_params_from_hf_state_dict,
                         ModelConfig.tiny_moe(num_experts=4))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mapper({}, cfg)


def _decode_args(device):
    kw = dict(device=device)
    return (torch.zeros(2, 4, 64, dtype=torch.bfloat16, **kw),
            torch.zeros(3, 2, 8, 64, dtype=torch.bfloat16, **kw),
            torch.zeros(3, 2, 8, 64, dtype=torch.bfloat16, **kw),
            torch.zeros(2, 1, dtype=torch.int32, **kw),
            torch.ones(2, dtype=torch.int32, **kw))


def _qblock_args(device):
    q, kp, vp, tbl, _ = _decode_args(device)
    return (q[:, None], kp, vp, tbl,
            torch.zeros(2, 1, dtype=torch.int32, device=device))


@pytest.mark.parametrize("mod,args", [(pfd, _decode_args),
                                      (pfq, _qblock_args)],
                         ids=["decode", "qblock"])
def test_wrappers_take_plain_version_only_on_cpu(mod, args, monkeypatch):
    op = getattr(mod, mod.__name__.rsplit(".", 1)[1])
    ref_name = mod.__name__.rsplit(".", 1)[1] + "_ref"
    calls = []
    real_ref = getattr(mod, ref_name)
    monkeypatch.setattr(mod, ref_name,
                        lambda *a: calls.append(1) or real_ref(*a))
    before = mod.KERNEL.launches
    out = op(*args("cpu"))
    assert calls == [1] and out.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        op(*args("meta"))
    assert calls == [1], "a non-CPU tensor reached the plain version"
    assert mod.KERNEL.launches == before


def test_tp_slice_modules_are_checked_and_need_cuda():
    """The tensor-parallel slice's modules are among the sources checked
    above; ``make_mesh()`` (and so a tp engine) needs the card unless
    given ``device="cpu"``."""
    from triton_dist_tpu_torch import make_mesh

    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("parallel/mesh.py", "lang/overlap.py", "shmem/workspace.py",
                "ops/tp_gemm.py", "ops/ag_gemm.py", "ops/gemm_rs.py",
                "ops/gemm_ar.py", "utils/device.py"):
        assert f"triton_dist_tpu_torch/{mod}" in names
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(tp=4)
    assert make_mesh(tp=4, device="cpu").tp == 4


def test_ep_slice_modules_are_checked():
    """The expert-parallel slices' modules are among the sources checked
    above, and an EP engine, like every engine, needs the card unless
    given ``device="cpu"``."""
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("ops/all_to_all.py", "ops/low_latency.py", "ops/ep_a2a.py",
                "ops/ep_fused.py", "layers/ep_moe.py"):
        assert f"triton_dist_tpu_torch/{mod}" in names
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = ModelConfig.tiny_moe(num_experts=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, moe_impl="ep")
    Engine(cfg, device="cpu", dtype=torch.float32, moe_impl="ep")
