"""The port does all that the JAX package does: every module under
``aqc_research_tpu/`` has a counterpart in ``aqc_research_tpu_torch/`` or
sits in ``NOT_PORTED`` with a reason that ROADMAP.md's "Not to port" list
gives, and every public function, class and module-level name of a mapped
module resolves in its counterpart or sits in ``ABSENT`` with a reason.

The JAX package is read with ``ast`` (nothing of it is imported); the port's
modules are imported (torch only)."""

import ast
import importlib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "aqc_research_tpu"

# JAX module -> the port's module where the path differs.
MODULE_MAP = {
    "ops/pallas_jacobi.py": "ops/jacobi_kernel.py",  # K1's wrapper: the CUDA kernel replaces Pallas
    "ops/svd_tpu.py": "ops/svd_gram.py",  # its "gram" route
}

# JAX modules the port leaves out; each reason names the file as ROADMAP.md's
# "Not to port" list does.
NOT_PORTED = {
    "ops/blocked_jacobi.py": "`ops/blocked_jacobi.py`: a pinned negative",
    "ops/roofline.py": "`ops/roofline.py`: the TPU's roofline model",
    "parallel/collective_model.py": "`parallel/collective_model.py`: the TPU mesh's collective-cost model",
}

# Public names that live under another name in the port.
RENAMED = {
    ("ops/pallas_jacobi.py", "jacobi_svd_pallas_top_k"): "jacobi_svd_kernel_top_k",
    ("ops/fused_pair.py", "theta_build_raw"): "theta_build",
}

# Deliberate absences: (module, name) -> (token of ROADMAP's "Not to port"
# list or None, reason).
ABSENT = {
    ("config.py", "is_tpu"): (None, "the port runs on CUDA or the CPU; config.device() says which"),
    ("config.py", "set_eigh_svd"): ('"embed" route', 'back-compat alias of the "embed" route'),
    ("config.py", "use_eigh_svd"): ('"embed" route', 'back-compat alias of the "embed" route'),
    ("config.py", "set_svd_chunk"): (None, "caps the Pallas kernels' VMEM batch chunk; the CUDA kernels "
                                           "take one block or cluster per matrix and have no chunk"),
    ("config.py", "svd_chunk"): (None, "see set_svd_chunk"),
    ("ops/svd_tpu.py", "svd_top_k"): ('"embed" route', "the embed route works around a TPU complex-buffer fault"),
    ("ops/pallas_jacobi.py", "jacobi_svd_pallas"): (None, "the engine takes top-χ factors only; "
                                                          "jacobi_svd_kernel_top_k with k = columns is the full SVD"),
    ("ops/jacobi_svd.py", "jacobi_sweeps_used"): ("ops/roofline.py", "the sweep count behind the roofline's flop "
                                                                     "accounting; the kernels report their own sweeps"),
    ("utils/__init__.py", "from_host"): ("from_host", "TPU host-transfer workaround"),
    ("utils/__init__.py", "as_device"): ("from_host", "TPU host-transfer workaround (from_host's helper)"),
    ("utils/__init__.py", "to_host"): ("to_host", "TPU host-transfer workaround"),
    ("utils/__init__.py", "rand_thetas_key"): (None, "draws from a JAX key; the port draws from a torch.Generator "
                                                     "(rand_thetas_gen)"),
    ("parallel/mesh.py", "state_sharding"): (None, "a NamedSharding: the port is SPMD, each rank holds its own "
                                                   "shard (shard_state)"),
    ("parallel/mesh.py", "batch_sharding"): (None, "a NamedSharding: each rank holds its rows (shard_batch)"),
    ("parallel/mesh.py", "replicated"): (None, "a NamedSharding: a replicated value is every rank's own copy"),
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _public_names(rel: str):
    """Top-level functions, classes and assigned names of a JAX module."""
    tree = ast.parse((JAX / rel).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return sorted(n for n in names if not n.startswith("_"))


def _port_module(rel: str):
    path = MODULE_MAP.get(rel, rel)
    dotted = "aqc_research_tpu_torch." + path[: -len(".py")].replace("/", ".")
    return importlib.import_module(dotted.removesuffix(".__init__"))


def _not_to_port_section() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Not to port.**")
    return text[start: text.index("\n### ", start)]


def test_every_jax_module_maps_or_is_not_ported():
    section = _not_to_port_section()
    missing = []
    for rel in _jax_modules():
        if rel in NOT_PORTED:
            assert re.search(re.escape(rel.split("/")[-1]), section), f"{rel} is not in ROADMAP's Not to port list"
            continue
        try:
            _port_module(rel)
        except ImportError as exc:
            missing.append(f"{rel}: {exc}")
    assert missing == []


@pytest.mark.parametrize("rel", [m for m in _jax_modules() if m not in NOT_PORTED])
def test_every_public_name_resolves(rel):
    mod = _port_module(rel)
    section = _not_to_port_section()
    missing = []
    for name in _public_names(rel):
        if (rel, name) in ABSENT:
            token, reason = ABSENT[(rel, name)]
            assert reason and (token is None or token in section), (rel, name, token)
            continue
        if not hasattr(mod, RENAMED.get((rel, name), name)):
            missing.append(name)
    assert missing == [], f"{rel}: no counterpart in {mod.__name__} for {missing}"


def test_absences_name_real_jax_names():
    for (rel, name) in list(ABSENT) + list(RENAMED):
        assert name in _public_names(rel), (rel, name)
