"""The port does all that the JAX package does: every module under
``aqc_research_tpu/`` has a counterpart in ``aqc_research_tpu_torch/`` or
sits in ``NOT_PORTED`` with a reason that ROADMAP.md's "Not to port" list
gives, and every public function, class and module-level name of a mapped
module resolves in its counterpart or sits in ``ABSENT`` with a reason.
Below the names: every parameter of every public function, and of every
public method of a public class, is accepted by its counterpart (a
property or field must exist) or sits in ``PARAM_ABSENT`` with a reason;
and every ``AQC_TPU_*`` environment knob the JAX package reads has an
``AQC_TORCH_*`` knob that the port reads, is read by the port under the
same name (``KNOB_SHARED``), or sits in ``KNOB_ABSENT`` with a reason.

The JAX package is read with ``ast`` (nothing of it is imported); the port's
modules are imported (torch only), and its knobs read from its source."""

import ast
import importlib
import inspect
import pathlib
import re

import pytest

from tests import _torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "aqc_research_tpu"
PORT = ROOT / "aqc_research_tpu_torch"

# JAX module -> the port's module where the path differs.
MODULE_MAP = {
    "ops/pallas_jacobi.py": "ops/jacobi_kernel.py",  # K1's wrapper: the CUDA kernel replaces Pallas
    "ops/svd_tpu.py": "ops/svd_gram.py",  # its "gram" route
}

# JAX modules the port leaves out; each reason names the file as ROADMAP.md's
# "Not to port" list does.
NOT_PORTED = {
    "ops/blocked_jacobi.py": "`ops/blocked_jacobi.py`: a pinned negative",
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
    ("parallel/collective_model.py", "census_hlo"): (None, "counts the ops of a compiled HLO text; the port has "
                                                             "no compiled program, its census spies on the "
                                                             "collectives as they run (collective_log)"),
    ("utils/__init__.py", "from_host"): ("from_host", "TPU host-transfer workaround"),
    ("utils/__init__.py", "as_device"): ("from_host", "TPU host-transfer workaround (from_host's helper)"),
    ("utils/__init__.py", "to_host"): ("to_host", "TPU host-transfer workaround"),
    ("utils/__init__.py", "rand_thetas_key"): (None, "draws from a JAX key; the port draws from a torch.Generator "
                                                     "(rand_thetas_gen)"),
    ("parallel/mesh.py", "state_sharding"): (None, "a NamedSharding: the port is SPMD, each rank holds its own "
                                                   "shard (shard_state)"),
    ("parallel/mesh.py", "batch_sharding"): (None, "a NamedSharding: each rank holds its rows (shard_batch)"),
    ("parallel/mesh.py", "replicated"): (None, "a NamedSharding: a replicated value is every rank's own copy"),
    ("utils/profiling.py", "device_timer"): (None, "nothing in the port read it; spans time the program's "
                                                   "layers and CUDA events its replays (span, device_span)"),
    ("utils/profiling.py", "time_jitted"): (None, "nothing in the port read it; the benchmark (h100bench) and "
                                                  "the program's spans time the programs"),
}


# Parameters (or, with None, whole methods) of a mapped JAX module that the
# port's counterpart does not take: (module, function or Class.method,
# parameter) -> reason.
PARAM_ABSENT = {
    ("ops/fused_pair.py", "theta_build_raw", "chi"): "χ comes from the planes' shape",
    ("ops/fused_pair.py", "theta_build_raw", "chunk"): "the Pallas kernel's VMEM batch chunk; the CUDA kernel "
                                                       "takes one block per output tile",
    ("optim/lbfgs.py", "lbfgs_chunk_programs", "opts"): "the options it forwards are named keywords in the port "
                                                        "(maxiter ... fuse_linesearch_grad)",
    ("optim/lbfgs.py", "run_lbfgs_chunked", "args"): "the jit's tuple of the objective's data: the port's "
                                                     "programs are closures over it",
    ("parallel/mesh.py", "make_mesh", "devices"): "a torch.distributed mesh spans process ranks (ranks=), "
                                                  "not device objects",
    ("parallel/multistart.py", "random_initial_thetas", "key"): "a JAX PRNG key; the port draws from a "
                                                                "torch.Generator (generator)",
    ("parallel/collective_model.py", "collective_census", "hlo_text"): "a compiled HLO text; the port's census "
                                                                       "reads every rank's log of a run (logs)",
    ("parallel/collective_model.py", "fit_chain_model", "devices"): "the JAX devices of a virtual mesh; the port "
                                                                    "counts in P Gloo processes on the CPU",
    ("parallel/collective_model.py", "validate_chain_model", "devices"): "see fit_chain_model(devices=)",
    ("ops/mps.py", "MPS.tree_flatten", None): "JAX pytree registration; torch has no pytree classes",
    ("ops/mps.py", "MPS.tree_unflatten", None): "JAX pytree registration; torch has no pytree classes",
    ("parallel/mps_chain.py", "ChainMPS.tree_flatten", None): "JAX pytree registration; torch has no pytree "
                                                              "classes",
    ("parallel/mps_chain.py", "ChainMPS.tree_unflatten", None): "JAX pytree registration; torch has no pytree "
                                                                "classes",
}

# AQC_TPU_* knobs the port reads under the same name: the launchers' variables.
KNOB_SHARED = {
    "AQC_TPU_COORDINATOR": "the process group's address, as the JAX launchers set it (beside torchrun's)",
    "AQC_TPU_NUM_PROCESSES": "the world size, as the JAX launchers set it (beside torchrun's WORLD_SIZE)",
    "AQC_TPU_PROCESS_ID": "this rank, as the JAX launchers set it (beside torchrun's RANK)",
}

# AQC_TPU_* knobs without a counterpart: name -> (token of ROADMAP's "Not to
# port" list or None, reason).
KNOB_ABSENT = {
    "AQC_TPU_AUTO_DIST": (None, "discovers a TPU slice from the cloud's metadata; torchrun's environment or "
                                "explicit arguments take its place"),
    "AQC_TPU_CHOLQR_CHOL": ("cholqr", "the Cholesky of the cholqr stabilizer, measured unsafe"),
    "AQC_TPU_CHOLQR_SHIFT": ("cholqr", "the shift of the cholqr stabilizer, measured unsafe"),
    "AQC_TPU_RAND_FINAL": ("cholqr2/3", "selects a final basis other than Householder QR (cholqrK), measured "
                                        "unsafe; the port's only final basis is qr (rand_svd_top_k(final=))"),
    "AQC_TPU_RAND_TAIL_CHUNK": (None, "the rand tail's VMEM batch chunk floor; K3 takes one CTA cluster or "
                                      "block per matrix"),
    "AQC_TPU_SMALL_CHUNK": (None, "the Jacobi kernel's VMEM chunk for small matrices; K1 takes one block "
                                  "or cluster per matrix"),
    "AQC_TPU_SVD_CHUNK": (None, "caps the Pallas kernels' VMEM batch chunk (see set_svd_chunk)"),
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


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _is_property(fn: ast.FunctionDef) -> bool:
    return any((isinstance(d, ast.Name) and d.id in ("property", "cached_property"))
               or (isinstance(d, ast.Attribute) and d.attr in ("cached_property", "setter"))
               for d in fn.decorator_list)


def _public_callables(rel: str):
    """(qualname, ast node) of the public functions of a JAX module and the
    public methods of its public classes."""
    tree = ast.parse((JAX / rel).read_text())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            yield node.name, node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and not sub.name.startswith("_"):
                    yield f"{node.name}.{sub.name}", sub


def _has_member(cls, name: str) -> bool:
    return hasattr(cls, name) or name in getattr(cls, "__dataclass_fields__", {})


@pytest.mark.parametrize("rel", [m for m in _jax_modules() if m not in NOT_PORTED])
def test_every_parameter_is_accepted(rel):
    mod = _port_module(rel)
    missing = []
    for qual, node in _public_callables(rel):
        owner, _, meth = qual.partition(".")
        if (rel, owner) in ABSENT:
            continue
        obj = getattr(mod, RENAMED.get((rel, owner), owner))
        if meth:
            if (rel, qual, None) in PARAM_ABSENT:
                continue
            if not _has_member(obj, meth):
                missing.append(f"{qual} (no such member)")
                continue
            if _is_property(node):
                continue
            obj = getattr(obj, meth)
        params = inspect.signature(obj).parameters
        takes_any = any(p.kind == p.VAR_KEYWORD for p in params.values())
        for name in _params(node):
            if name in params or takes_any or (rel, qual, name) in PARAM_ABSENT:
                continue
            missing.append(f"{qual}({name}=)")
    assert missing == [], f"{rel}: parameters the port does not take: {missing}"


def _knobs(root: pathlib.Path, prefix: str):
    """The knob names a package's source reads: string constants that are a
    whole ``prefix`` name (docstrings that mention one do not count)."""
    pat = re.compile(rf"{prefix}[A-Z0-9_]+")
    found = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and pat.fullmatch(node.value):
                found.add(node.value)
    return found


JAX_KNOBS = sorted(_knobs(JAX, "AQC_TPU_"))


def test_the_knob_census_sees_the_known_knobs():
    assert {"AQC_TPU_RAND_INTERMEDIATE", "AQC_TPU_ALLOW_UNFUSED_RAND", "AQC_TPU_SVD_IMPL"} <= set(JAX_KNOBS)
    assert len(JAX_KNOBS) >= 20


@pytest.mark.parametrize("knob", JAX_KNOBS)
def test_every_knob_has_a_counterpart(knob):
    section = _not_to_port_section()
    if knob in KNOB_ABSENT:
        token, reason = KNOB_ABSENT[knob]
        assert reason and (token is None or token in section), (knob, token)
        return
    port = _knobs(PORT, "AQC_")
    if knob in KNOB_SHARED:
        assert KNOB_SHARED[knob] and knob in port, knob
        return
    twin = "AQC_TORCH_" + knob[len("AQC_TPU_"):]
    assert twin in port, f"{knob}: the port reads no {twin}"


def test_param_and_knob_absences_name_real_jax_names():
    for (rel, qual, name) in PARAM_ABSENT:
        nodes = dict(_public_callables(rel))
        assert qual in nodes, (rel, qual)
        assert name is None or name in _params(nodes[qual]), (rel, qual, name)
        assert PARAM_ABSENT[(rel, qual, name)]
    for knob in list(KNOB_ABSENT) + list(KNOB_SHARED):
        assert knob in JAX_KNOBS, knob
