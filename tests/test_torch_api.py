"""The port's public names against the reference's, read from the sources
with ``ast`` (neither package is imported, so no JAX runs).

For every module of ``src/repro`` the port has a module of the same path.
Every public function and method there (a name without a leading
underscore, and ``__init__``) has the reference's parameters: the same
names in the same order, of the same kinds, with the same defaults; and
every module constant (an UPPER_CASE name bound at module level) has the
reference's value expression. The port may add names of its own.

The differences the port makes on purpose are listed below, each with its
reason, and a test holds every entry to a real difference.

    PYTHONPATH=src python -m pytest tests/test_torch_api.py
"""
import ast
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
CONSTANT = re.compile(r"^[A-Z][A-Z0-9_]*$")

# Rules that hold for every signature, applied before the comparison:
# - a trailing ``device`` parameter (default None) on what allocates: the port
#   runs on the card unless the caller asks for the CPU;
# - ``generator`` (a torch.Generator) in place of a ``jax.random`` ``key``;
# - a command line's ``main`` takes ``argv`` (default None), so that tests call it;
# - a default naming a jnp dtype is torch's dtype of the same name.
RULES = ("device=", "generator for key", "main(argv=None)", "torch dtypes for jnp's")

# (module, function or Class.method) -> why the port's parameters differ
SIGNATURE_DIFFERENCES = {
    ("core/cache.py", "PatchCache.__init__"):
        "allocates at the first update, so item_shape and dtype are gone",
    ("core/cache.py", "masked_block_apply"): "drops the unused fill_inputs",
    ("core/serving.py", "PatchedServeEngine.__init__"):
        "takes device and the VAE's params (vae_params), which the reference draws from "
        "jax.random.PRNGKey(7)",
    ("kernels/groupnorm_stitch.py", "groupnorm_stitch"):
        "the kernel redesigned for Hopper: takes the CSP metadata and groups and finalises "
        "the statistics itself; no Pallas interpret flag",
    ("kernels/ops.py", "grouped_attention_kernel"):
        "the CUDA kernel picks its own tiles: no block_q/block_k hints",
    ("kernels/patch_attention.py", "patch_attention"):
        "the CUDA kernel picks its own tiles: no block_q, block_k or interpret",
    ("launch/dryrun.py", "parse_collectives"):
        "reads CommDebugMode records of a fake process group, not XLA's HLO text",
    ("launch/steps.py", "build_cell"):
        "takes params, opt, batch and cache, so that a caller can hold the cell's steps "
        "to the plain ones on the same inputs",
    ("models/layers.py", "ParamBuilder.__init__"):
        "a torch.Generator for the key, a float32 default dtype and device",
    ("models/layers.py", "ParamBuilder.make"): "axes default to None, all replicated",
    ("optim/compression.py", "init_error_state"):
        "takes the gradient tensors, where the reference takes an abstract tree",
    ("optim/compression.py", "quantized_psum"):
        "takes a process group in place of a mapped axis name",
}
# (module, constant) -> why the port's value differs
CONSTANT_DIFFERENCES = {
    ("launch/roofline.py", "PEAK_FLOPS"): "the H100's dense bf16 peak, not the TPU's",
    ("launch/roofline.py", "HBM_BW"): "the H100's HBM rate, not the TPU's",
}


def _params(fn: ast.FunctionDef) -> list:
    """(name, kind, default source or None) for each parameter, in order."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + [ast.unparse(d) for d in a.defaults]
    out = [(p.arg, "positional", d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append((a.vararg.arg, "*", None))
    out += [(p.arg, "keyword", None if d is None else ast.unparse(d))
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append((a.kwarg.arg, "**", None))
    return out


def _names(path: Path) -> tuple:
    """({function or Class.method: params}, {constant: value source})."""
    funcs, consts = {}, {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (not m.name.startswith("_")
                                                       or m.name == "__init__"):
                    funcs[f"{node.name}.{m.name}"] = _params(m)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and CONSTANT.match(t.id):
                    consts[t.id] = ast.unparse(node.value)
    return funcs, consts


def _as_reference(name: str, params: list) -> list:
    """The port's parameters with the RULES undone."""
    if params and params[-1] == ("device", "positional", "None"):
        params = params[:-1]
    if name == "main" and params == [("argv", "positional", "None")]:
        params = []
    return [("key" if p == "generator" else p, kind, d) for p, kind, d in params]


def _normal(params: list) -> list:
    return [(p, kind, d if d is None else d.replace("jnp.", "torch."))
            for p, kind, d in params]


def _signature_diffs(rel: str) -> dict:
    ref, _ = _names(REF / rel)
    port, _ = _names(PORT / rel)
    out = {}
    for name, params in ref.items():
        if name not in port:
            out[name] = f"missing from the port (the reference takes {params})"
        elif _normal(_as_reference(name, port[name])) != _normal(params):
            out[name] = f"reference {params}, port {port[name]}"
    return out


def _constant_diffs(rel: str) -> dict:
    _, ref = _names(REF / rel)
    _, port = _names(PORT / rel)
    return {name: f"reference {value!r}, port {port.get(name, 'missing')!r}"
            for name, value in ref.items() if port.get(name) != value}


def test_every_reference_module_has_a_port():
    assert len(MODULES) > 60
    assert [m for m in MODULES if not (PORT / m).exists()] == []


@pytest.mark.parametrize("rel", MODULES)
def test_public_functions_take_the_reference_parameters(rel):
    diffs = {n: d for n, d in _signature_diffs(rel).items()
             if (rel, n) not in SIGNATURE_DIFFERENCES}
    assert diffs == {}


@pytest.mark.parametrize("rel", MODULES)
def test_module_constants_equal_the_reference(rel):
    diffs = {n: d for n, d in _constant_diffs(rel).items()
             if (rel, n) not in CONSTANT_DIFFERENCES}
    assert diffs == {}


def test_every_documented_difference_is_real():
    """An entry whose names have come to agree is stale and must go."""
    for (rel, name), reason in SIGNATURE_DIFFERENCES.items():
        assert reason and name in _signature_diffs(rel), (rel, name)
    for (rel, name), reason in CONSTANT_DIFFERENCES.items():
        assert reason and name in _constant_diffs(rel), (rel, name)
