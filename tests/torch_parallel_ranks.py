"""The rank programs of ``test_torch_port_parallel.py``.

``run_world(world, workdir)`` spawns a gloo world of ``world`` processes on
the CPU. Each rank reads the inputs the test wrote (``inputs.npz``), runs
every sharded function of ``graph_neural_pde_tpu_torch.parallel`` on its
shard, forward and backward, and writes what it holds (``rank<r>.npz``);
the test compares them with the JAX package's shard functions on a mesh of
the same size. This module imports no jax (nor does anything it imports):
the ranks are fresh interpreters, and jax has no place in them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

HEADS = 2


def run_world(world: int, workdir: str):
    """Spawn the world, wait for it, and return each rank's results."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(world, workdir), nprocs=world, join=True)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]


def leaf(a, grad=True):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def grads(loss, leaves):
    """Each leaf's gradient as a numpy array (a bfloat16 one widened to
    float32; its dtype must be the leaf's)."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t, g in zip(leaves, gs):
        assert g is None or g.dtype == t.dtype, (g.dtype, t.dtype)
    return [np.zeros(t.shape, np.float32) if g is None else g.float().numpy()
            for t, g in zip(leaves, gs)]


def base_graph(inp):
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    return make_graph(inp["row"], inp["col"], num_nodes=int(inp["n"]),
                      pad_multiple=8)


def prepared(cfg, g, multiple: int = 4):
    """``cfg``'s block preparation, padded to a capacity the meshes of 2
    and 4 divide, and sorted again (``pad_capacity`` drops the CSR)."""
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    from graph_neural_pde_tpu_torch.ops.graph import pad_capacity
    return pad_capacity(prepare_graph(cfg, g), multiple).sort_by_row()


def laplacian_config():
    from graph_neural_pde_tpu_torch.config import Config
    return Config(block="constant", function="laplacian", method="rk4",
                  step_size=0.5, time=1.0, hidden_dim=8,
                  self_loop_weight=1.0)


def attention_config():
    """The tuned Cora row's attention block at reduced width and time."""
    from graph_neural_pde_tpu_torch.config import best_params
    return best_params["Cora"].replace(hidden_dim=8, attention_dim=8,
                                       heads=2, time=3.0)


def block_run(cfg, g, x, probe, spmm_fn=None):
    """z and the gradients of sum(z * probe) in x and the block's
    parameters (tuple order: x, then ``named_parameters``)."""
    from graph_neural_pde_tpu_torch.models.blocks import ODEBlock, block_forward
    block = ODEBlock(cfg, x.shape[1],
                     generator=torch.Generator().manual_seed(0))
    z, stats = block_forward(block, cfg, g, x, True, spmm_fn=spmm_fn)
    leaves = [x] + [p for _, p in block.named_parameters()]
    return [z.detach().numpy()] + grads((z * probe).sum(), leaves), stats


def _row_range(world, rank, n):
    blk = -(-n // world)
    return min(n, rank * blk), min(n, (rank + 1) * blk)


def _spmm_checks(mesh, inp, res):
    from graph_neural_pde_tpu_torch.config import Config
    from graph_neural_pde_tpu_torch.parallel.mesh import edge_ranges
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        MODES, make_sharded_spmm, make_sharded_spmm_for,
        make_sharded_spmm_stream, make_sharded_stripe_spmm)
    g = base_graph(inp)
    x, w, probe = leaf(inp["x"]), leaf(inp["w"]), leaf(inp["probe"], False)
    lo, hi = edge_ranges(mesh, g.capacity)[0]
    r0, r1 = _row_range(mesh.size, mesh.ranks[0], g.num_nodes)

    f = make_sharded_spmm(mesh, g)
    w_own = leaf(inp["w"][lo:hi])               # spec P(axis)
    out = f(x, w_own)
    res["ar_out"] = out.detach().numpy()
    res["ar_dx"], res["ar_dw_own"] = grads((out * probe).sum(), [x, w_own])
    res["ar_dw_whole"], = grads((f(x, w) * probe).sum(), [w])

    f = make_sharded_spmm_stream(mesh, g)
    out = f(x, w)                               # this rank's rows
    res["st_out"] = out.detach().numpy()
    res["st_dx"], res["st_dw"] = grads((out * probe[r0:r1]).sum(), [x, w])
    x_own = x.detach()[r0:r1]
    for _ in range(3):
        x_own = f(x_own, w) + 0.1 * x_own
    res["st_chain"] = x_own.detach().numpy()
    for k, v in f.buckets.__dict__.items():
        res[f"st_buckets_{k}"] = np.asarray(v)
    for mode in MODES:
        out = make_sharded_spmm_for(Config(shard_spmm_mode=mode), mesh, g)(
            x, w)
        res[f"spmm_for_{mode}"] = out.detach().numpy()
        res[f"spmm_for_{mode}_dx"], res[f"spmm_for_{mode}_dw"] = grads(
            (out * probe).sum(), [x, w])

    gp = prepared(laplacian_config(), g)
    f = make_sharded_stripe_spmm(mesh, gp)
    wp = leaf(inp["w_prepared"])
    out = f(x, wp)
    res["stripe_out"] = out.detach().numpy()
    res["stripe_dx"], res["stripe_dw"] = grads((out * probe).sum(), [x, wp])
    res["stripe_lo_hi"] = np.array([f.shards[0].lo, f.shards[0].hi])
    # the bfloat16 payload: each rank's bf16 products x_b[col] * w_b, K1 in
    # table mode on them, K20 writing their bf16 gradient
    f = make_sharded_stripe_spmm(mesh, gp, payload_dtype=torch.bfloat16)
    out = f(x, wp)
    res["stripe_bf16_out"] = out.detach().numpy()
    res["stripe_bf16_dx"], res["stripe_bf16_dw"] = grads((out * probe).sum(),
                                                         [x, wp])


def _fused_checks(mesh, inp, res):
    from graph_neural_pde_tpu_torch.config import Config
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        MODES, make_sharded_fused_rhs, make_sharded_fused_rhs_for,
        make_sharded_fused_rhs_stream)
    g = base_graph(inp)
    params = [leaf(inp[k]) for k in ("qw", "qb", "kw", "kb")]
    x, probe = leaf(inp["xf"]), leaf(inp["probe_f"], False)
    r0, r1 = _row_range(mesh.size, mesh.ranks[0], g.num_nodes)
    for sp in (False, True):
        tag = f"sp{int(sp)}"
        f = make_sharded_fused_rhs(mesh, g, heads=HEADS, square_plus=sp)
        out = f(*params, x)
        res[f"fa_{tag}_out"] = out.detach().numpy()
        for i, gr in enumerate(grads((out * probe).sum(), params + [x])):
            res[f"fa_{tag}_d{i}"] = gr
        f = make_sharded_fused_rhs_stream(mesh, g, heads=HEADS,
                                          square_plus=sp)
        out = f(*params, x)
        res[f"fs_{tag}_out"] = out.detach().numpy()
        for i, gr in enumerate(grads((out * probe[r0:r1]).sum(),
                                     params + [x])):
            res[f"fs_{tag}_d{i}"] = gr
    f = make_sharded_fused_rhs_stream(mesh, g, heads=HEADS)
    x_own = x.detach()[r0:r1]
    for _ in range(3):
        x_own = x_own + 0.25 * (f(*params, x_own) - x_own)
    res["fs_chain"] = x_own.detach().numpy()
    for mode in MODES:
        out = make_sharded_fused_rhs_for(Config(shard_spmm_mode=mode), mesh,
                                         g, heads=HEADS)(*params, x)
        res[f"fused_for_{mode}"] = out.detach().numpy()
        for i, gr in enumerate(grads((out * probe).sum(), params + [x])):
            res[f"fused_for_{mode}_d{i}"] = gr


def _precision_checks(mesh, inp, res):
    """Both dispatchers in both modes under the bf16 ODE state (x the
    inputs rounded to bfloat16, the config's payload and state bfloat16)
    and under the bfloat16 payload alone (float32 x, which they run as
    float32, as the JAX dispatchers ignore the payload)."""
    from graph_neural_pde_tpu_torch.config import Config
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        MODES, make_sharded_fused_rhs_for, make_sharded_spmm_for)
    g = base_graph(inp)
    w, probe = leaf(inp["w"]), leaf(inp["probe"], False)
    params = [leaf(inp[k]) for k in ("qw", "qb", "kw", "kb")]
    probe_f = leaf(inp["probe_f"], False)
    states = {"bf16": dict(dtype="bfloat16", rhs_payload_dtype="bfloat16"),
              "pay": dict(rhs_payload_dtype="bfloat16")}
    for tag, over in states.items():
        wide = torch.float32 if tag == "pay" else torch.bfloat16
        for mode in MODES:
            cfg = Config(shard_spmm_mode=mode, **over)
            x = torch.tensor(inp["x"]).to(wide).requires_grad_(True)
            out = make_sharded_spmm_for(cfg, mesh, g)(x, w)
            res[f"{tag}_spmm_{mode}"] = out.detach().numpy()
            res[f"{tag}_spmm_{mode}_dx"], res[f"{tag}_spmm_{mode}_dw"] = \
                grads((out * probe).sum(), [x, w])
            x = torch.tensor(inp["xf"]).to(wide).requires_grad_(True)
            out = make_sharded_fused_rhs_for(cfg, mesh, g,
                                             heads=HEADS)(*params, x)
            res[f"{tag}_fused_{mode}"] = out.detach().numpy()
            for i, gr in enumerate(grads((out * probe_f).sum(),
                                         params + [x])):
                res[f"{tag}_fused_{mode}_d{i}"] = gr


def _stream_spmm(mesh, g):
    """The ring schedule through its dispatcher: whole in, whole out."""
    from graph_neural_pde_tpu_torch.config import Config
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        make_sharded_spmm_for)
    return make_sharded_spmm_for(Config(shard_spmm_mode="stream"), mesh, g)


def _block_checks(mesh, inp, res):
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        make_sharded_spmm, make_sharded_stripe_spmm)
    g = base_graph(inp)
    probe = leaf(inp["probe_b"], False)
    for name, cfg in (("lap", laplacian_config()),
                      ("att", attention_config())):
        gp = prepared(cfg, g)
        for engine, make in (("ar", make_sharded_spmm),
                             ("stripe", make_sharded_stripe_spmm),
                             ("stream", _stream_spmm)):
            outs, stats = block_run(cfg, gp, leaf(inp["xb"]), probe,
                                    make(mesh, gp))
            for i, o in enumerate(outs):
                res[f"block_{name}_{engine}_{i}"] = o
            res[f"block_{name}_{engine}_nfe"] = np.array(int(stats["nfe"]))


def _rank_main(rank: int, world: int, workdir: str):
    torch.set_num_threads(1)
    from graph_neural_pde_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(world, "cpu",
                     init_method="file://" + os.path.join(workdir, "init"),
                     rank=rank, world_size=world)
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    res = {}
    _spmm_checks(mesh, inp, res)
    _fused_checks(mesh, inp, res)
    _precision_checks(mesh, inp, res)
    _block_checks(mesh, inp, res)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
