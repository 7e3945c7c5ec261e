"""Port parity on four gloo ranks on the CPU: GPipe (``pipelined_apply``),
``quantized_psum``, the MoE's expert-parallel layouts and ``build_cell``'s
DTensor steps, against the JAX reference (and the port's single-device
code) on the same numpy-seeded inputs.

This process computes the JAX side (one device; the reference's
multi-device ``quantized_psum`` runs in a subprocess with 4 forced host
devices) and writes the inputs as ``.npz``; four subprocesses, joined by a
``FileStore`` in ``tmp_path`` with a timeout on every group, run the port
and rank 0 writes its results. A rank that hangs is killed at the launch's
timeout and the test fails.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch.steps import make_decode_step as jdecode  # noqa: E402
from repro.launch.steps import make_prefill_step as jprefill  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import ParamBuilder as JParamBuilder  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 240

_WORKER = r'''
import dataclasses, datetime, sys
import numpy as np, torch, torch.distributed as dist
mode, rank, n, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", n), rank=rank,
                        world_size=n, timeout=datetime.timedelta(seconds=90))
torch.manual_seed(0)
from repro_torch.configs import ARCHS
from repro_torch.launch import context as ctx, sharding as shd, steps
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models.layers import tree_leaves, tree_map

def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def unflat(d, prefix):
    out = {}
    for k, v in d.items():
        if not k.startswith(prefix):
            continue
        node, parts = out, k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(v)
    return out

inp = dict(np.load(tmp + "/in.npz"))
res = {}
if mode == "pp":
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline import pipelined_apply
    from repro_torch.optim.compression import quantized_psum
    mesh = Mesh(("stage",), (n,), init_device_mesh("cpu", (n,), mesh_dim_names=("stage",)))
    W, x = torch.as_tensor(inp["W"]), torch.as_tensor(inp["x"])
    res["pp"] = pipelined_apply(lambda w, h: torch.tanh(h @ w), mesh, W, x).numpy()
    res["qpsum"] = quantized_psum(torch.as_tensor(inp["q"][rank])).numpy()
elif mode == "moe":
    from repro_torch.models import moe
    mesh = make_local_mesh(model=2, data=2)
    for case in inp["cases"]:
        case = str(case)
        E = int(case.split("_")[0][1:])
        cfg = dataclasses.replace(ARCHS["mixtral-8x7b"].reduced(), n_experts=E, moe_top_k=2,
                                  capacity_factor=8.0, n_shared_experts=0, fsdp=True)
        p = unflat(inp, case + "/p/")
        x = torch.as_tensor(inp[case + "/x"])
        r = torch.as_tensor(inp[case + "/r"])
        specs = {"router": (None, None), "w_gate": ("experts", "embed", "ff"),
                 "w_up": ("experts", "embed", "ff"), "w_down": ("experts", "ff", "embed")}
        sh = shd.param_shardings(cfg, mesh, p, specs)
        dp = {k: shd.place(v, sh[k]).requires_grad_(True) for k, v in p.items()}
        from torch.distributed.tensor.experimental import implicit_replication
        with ctx.use_mesh(mesh), implicit_replication():
            y, aux = moe.apply_moe(cfg, dp, x)
            loss = (y * r).sum() + aux
        res[case + "/y"], res[case + "/aux"] = full(y).detach().numpy(), full(aux).detach().numpy()
        lp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        yl, auxl = moe.apply_moe(cfg, lp, x)
        if x.shape[1] > 1:   # the train shapes: gradients of every weight
            with implicit_replication():
                loss.backward()
            # the EP aux is the mean of each data shard's aux
            auxl = sum(moe._moe_compute(cfg, h.reshape(-1, h.shape[-1]), lp["router"],
                                        lp["w_gate"], lp["w_up"], lp["w_down"], 0, E)[1]
                       for h in x.chunk(2)) / 2
            ((yl * r).sum() + auxl).backward()
            for k in p:
                res[case + "/gerr/" + k] = float((full(dp[k].grad) - lp[k].grad).abs().max()
                                                 / lp[k].grad.abs().max())
elif mode == "cells":
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.optim import opt_init
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = make_local_mesh(model=2, data=2)
    over = {"starcoder2-3b": {"n_heads": 3, "n_kv_heads": 1}}
    for arch in [str(a) for a in inp["archs"]]:
        cfg = ARCHS[arch].reduced(flash_min_seq=8, **over.get(arch, {}))
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0, fsdp=True)
        params = unflat(inp, arch + "/p/")
        tok = inp[arch + "/tok"]
        B, S = tok.shape
        batch = {"tokens": tok, "labels": tok}
        errs = {}
        # gradients: every leaf, DTensor against one device
        _, g0 = steps.loss_and_grads(cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()})
        _, specs = steps.abstract_params(cfg)
        psh = shd.param_shardings(cfg, mesh, params, specs)
        bsh = steps.batch_shardings(cfg, mesh, batch)
        with ctx.use_mesh(mesh), implicit_replication():
            _, g1 = steps.loss_and_grads(cfg, shd.tree_place(params, psh),
                                         shd.tree_place({k: torch.as_tensor(v) for k, v in batch.items()}, bsh))
        errs["grad"] = max(float((full(a) - b).abs().max() / (b.abs().max() + 1e-12))
                           for a, b in zip(tree_leaves(g1), tree_leaves(g0)))
        # train step
        tp, to, tm = steps.make_train_step(cfg, device="cpu")(params, opt_init(cfg, params), batch)
        fn, args, _ = steps.build_cell(cfg, ShapeSpec("t", S, B, "train"), mesh, params=params,
                                       opt=opt_init(cfg, params), batch=batch)
        dp_, do_, dm_ = fn(*args)
        errs["params"] = max(float((full(a) - b).abs().max()) for a, b in zip(tree_leaves(dp_), tree_leaves(tp)))
        errs["opt"] = max(float((full(a) - b).abs().max()) for a, b in zip(tree_leaves(do_), tree_leaves(to)))
        res[arch + "/loss"] = full(dm_["loss"]).numpy()
        errs["loss"] = float((full(dm_["loss"]) - tm["loss"]).abs())
        # prefill, then 3 decode steps on the cache padded by 4 slots
        lg, cache = steps.make_prefill_step(cfg, device="cpu")(params, {"tokens": tok})
        fnp, argsp, _ = steps.build_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh,
                                         params=params, batch={"tokens": tok})
        dlg, dcache = fnp(*argsp)
        res[arch + "/prefill"] = full(dlg).numpy()
        errs["prefill"] = float((full(dlg) - lg).abs().max())

        def pad(c):
            def one(t):
                if t.dim() >= 4 and t.shape[2] == S:
                    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, 4))
                return t
            return {"blocks": tree_map(lambda t: one(full(t)), c["blocks"]), "cur_len": c["cur_len"]}
        cache, dcache = pad(cache), pad(dcache)
        fnd, argsd, _ = steps.build_cell(cfg, ShapeSpec("d", S + 4, B, "decode"), mesh,
                                         params=params, cache=dcache, batch={"tokens": tok[:, :1]})
        dec = steps.make_decode_step(cfg, device="cpu")
        dlogits, dcache = [], argsd[1]
        errs["decode"] = 0.0
        for i in range(3):
            t1 = tok[:, i:i + 1]
            l1, cache = dec(params, cache, {"tokens": t1})
            dl1, dcache = fnd(argsd[0], dcache, {"tokens": t1})
            dlogits.append(full(dl1).numpy())
            errs["decode"] = max(errs["decode"], float((full(dl1) - l1).abs().max()))
        res[arch + "/decode"] = np.stack(dlogits)
        errs["cache"] = max(float((full(a) - b).abs().max()) for a, b in
                            zip(tree_leaves(dcache["blocks"]), tree_leaves(cache["blocks"])))
        for k, v in errs.items():
            res[arch + "/err/" + k] = v
if rank == 0:
    np.savez(tmp + "/out.npz", **res)
dist.barrier()
dist.destroy_process_group()
print("RANK-OK", rank)
'''


def _launch(tmp: Path, mode: str, inputs: dict, n: int = 4) -> dict:
    """Run the worker on ``n`` gloo ranks; rank 0's results."""
    np.savez(tmp / "in.npz", **inputs)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(tmp), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, mode, str(r), str(n), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK-OK {r}" in out, out[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# GPipe and quantized_psum
# ---------------------------------------------------------------------------

_QPSUM_REF = """
import jax, jax.numpy as jnp, numpy as np, sys
from jax.sharding import PartitionSpec as P
from repro.optim.compression import quantized_psum
mesh = jax.make_mesh((4,), ("d",))
x = jnp.asarray(np.load(sys.argv[1])["q"], jnp.float32)
got = jax.shard_map(lambda v: quantized_psum(v[0], "d"), mesh=mesh,
                    in_specs=P("d"), out_specs=P(), check_vma=False)(x)
np.save(sys.argv[2], np.asarray(got))
print("REF-OK")
"""


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(0)
    W = (rng.normal(size=(4, 8, 8)) * 0.3).astype(np.float32)
    x = rng.normal(size=(6, 2, 8)).astype(np.float32)       # 6 microbatches
    q = np.random.default_rng(0).normal(size=(4, 128)).astype(np.float32)
    np.savez(tmp / "q.npz", q=q)
    ref = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_QPSUM_REF), str(tmp / "q.npz"), str(tmp / "qref.npy")],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": str(tmp), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert ref.returncode == 0 and "REF-OK" in ref.stdout, ref.stderr[-4000:]
    out = _launch(tmp, "pp", {"W": W, "x": x, "q": q})
    return {"W": W, "x": x, "q": q, "qref": np.load(tmp / "qref.npy"), **out}


def test_pipelined_apply_matches_sequential(pp_run):
    """The reference test's W (4,8,8), x (6,2,8): four stages, six
    microbatches, against the stages applied in sequence."""
    want = torch.as_tensor(pp_run["x"])
    for s in range(4):
        want = torch.tanh(want @ torch.as_tensor(pp_run["W"][s]))
    np.testing.assert_allclose(pp_run["pp"], want.numpy(), rtol=0, atol=1e-5)


def test_quantized_psum_matches_reference(pp_run):
    """Four ranks against the reference's ``shard_map`` over four host
    devices: the same scale, codes and sums; and within quantization noise
    of the exact sum, as the reference test bounds it."""
    np.testing.assert_allclose(pp_run["qpsum"], pp_run["qref"], rtol=0, atol=1e-6)
    assert np.abs(pp_run["qpsum"] - pp_run["q"].sum(0)).max() < 0.2


# ---------------------------------------------------------------------------
# MoE expert parallelism
# ---------------------------------------------------------------------------

# E=4 on 2x2: 2D EP, the weights gathered over "data" at (4, 32) (enough
# tokens that gathering them would move more than the weights do), the
# tokens at the decode-size (2, 1); E=2: experts on "model"; E=3: ff split
# over "model"
MOE_CASES = {"E4_train": (4, (4, 32), "2d_weight_gather"),
             "E4_decode": (4, (2, 1), "2d_token_gather"),
             "E2_train": (2, (4, 8), "expert_on_model"),
             "E3_train": (3, (4, 8), "ff_tp")}


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    inputs, want = {"cases": np.array(list(MOE_CASES))}, {}
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import ep_layout
    for case, (E, (B, S), layout) in MOE_CASES.items():
        over = dict(n_experts=E, moe_top_k=2, capacity_factor=8.0, n_shared_experts=0,
                    fsdp=True)
        cfg = dataclasses.replace(JARCHS["mixtral-8x7b"].reduced(), **over)
        assert ep_layout(dataclasses.replace(ARCHS["mixtral-8x7b"].reduced(), **over),
                         Mesh(("data", "model"), (2, 2)), B, S) == layout
        b = JParamBuilder(jax.random.PRNGKey(0), jnp.float32)
        jmoe.init_moe(cfg, b, cfg.d_model, cfg.d_ff)
        rng = np.random.default_rng(E + B)
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        y, aux = jmoe.apply_moe(cfg, b.params, jnp.asarray(x))
        if layout != "2d_token_gather":
            # the reference's EP aux is the pmean of each data shard's aux
            # (token gather routes every token of the data group together)
            pp = b.params
            aux = np.mean([float(jmoe._moe_compute(
                cfg, jnp.asarray(h.reshape(-1, cfg.d_model)), pp["router"], pp["w_gate"],
                pp["w_up"], pp["w_down"], 0, E)[1]) for h in np.split(x, 2)])
        inputs.update(_flat(b.params, case + "/p/"))
        inputs[case + "/x"] = x
        inputs[case + "/r"] = rng.normal(size=x.shape).astype(np.float32)
        want[case] = (np.asarray(y), float(aux))
    return _launch(tmp, "moe", inputs), want


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_expert_parallel_matches_reference(moe_run, case):
    """``apply_moe`` on the 2x2 mesh against the reference's local
    ``apply_moe`` on the same params, at 1e-4; the aux loss against the
    reference's ``pmean`` of each data shard's aux."""
    got, want = moe_run
    np.testing.assert_allclose(got[case + "/y"], want[case][0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[case + "/aux"], want[case][1], rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["E4_train", "E2_train", "E3_train"])
def test_moe_expert_parallel_gradients(moe_run, case):
    """Every weight's gradient (router, w_gate, w_up, w_down) through the
    layout's gathers and partial sums, against the port's local path, at
    1e-4 of its largest entry."""
    got, _ = moe_run
    errs = {k: float(v) for k, v in got.items() if k.startswith(case + "/gerr/")}
    assert len(errs) == 4 and max(errs.values()) < 1e-4, errs


# ---------------------------------------------------------------------------
# build_cell's DTensor steps
# ---------------------------------------------------------------------------

# internlm2: heads over "model"; granite: tp_mode="sp"; mixtral: the MoE
# (token gather, with gradients); starcoder2 with 3 query heads (MQA):
# heads that do not split over "model", so the attention splits the query
# rows (and the biases); deepseek: MLA, whose decode cache is split over
# "model" along the sequence, shared experts and the MTP head
CELL_ARCHS = ["internlm2-1.8b", "granite-34b", "mixtral-8x7b", "starcoder2-3b",
              "deepseek-v3-671b"]
CELL_OVERRIDES = {"starcoder2-3b": {"n_heads": 3, "n_kv_heads": 1}}


def _jcfg(arch):
    cfg = JARCHS[arch].reduced(flash_min_seq=8, **CELL_OVERRIDES.get(arch, {}))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0, fsdp=True)
    return cfg


@pytest.fixture(scope="module")
def cells_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cells")
    inputs, want = {"archs": np.array(CELL_ARCHS)}, {}
    for arch in CELL_ARCHS:
        cfg = _jcfg(arch)
        jp, _ = jlm.init_model(cfg, jax.random.PRNGKey(0))
        tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        inputs.update(_flat(jp, arch + "/p/"))
        inputs[arch + "/tok"] = tok
        loss = jax.jit(lambda p, b: jlm.lm_loss(cfg, p, b))(
            jp, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)})
        logits, cache = jax.jit(jprefill(cfg))(jp, {"tokens": jnp.asarray(tok)})
        cache = {"blocks": jax.tree_util.tree_map(
            lambda a: jnp.pad(a, [(0, 0)] * 2 + [(0, 4)] + [(0, 0)] * (a.ndim - 3))
            if a.ndim >= 4 and a.shape[2] == 16 else a, cache["blocks"]),
            "cur_len": cache["cur_len"]}
        dec, dlogits = jax.jit(jdecode(cfg)), []
        for i in range(3):
            lg, cache = dec(jp, cache, {"tokens": jnp.asarray(tok[:, i:i + 1])})
            dlogits.append(np.asarray(lg))
        want[arch] = {"loss": float(loss), "prefill": np.asarray(logits),
                      "decode": np.stack(dlogits)}
    return _launch(tmp, "cells", inputs), want


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_build_cell_steps_match_one_device_and_reference(cells_run, arch):
    """Train (every gradient leaf, updated params and AdamW moments, loss),
    prefill and three decode steps (logits and every cache leaf) of
    ``build_cell`` on the 2x2 gloo mesh against the port's single-device
    steps, and the loss and logits against the JAX reference, at 1e-4.
    granite-34b runs tp_mode="sp" (the sequence-parallel constraints) and
    every arch the flash routes (``flash_min_seq=8``)."""
    got, want = cells_run
    errs = {k.split("/")[-1]: float(v) for k, v in got.items()
            if k.startswith(arch + "/err/")}
    assert set(errs) == {"grad", "params", "opt", "loss", "prefill", "decode", "cache"}
    assert max(errs.values()) < 1e-4, errs
    np.testing.assert_allclose(got[arch + "/loss"], want[arch]["loss"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[arch + "/prefill"], want[arch]["prefill"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[arch + "/decode"], want[arch]["decode"], rtol=0, atol=1e-4)
