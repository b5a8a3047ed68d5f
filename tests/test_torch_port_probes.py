"""K20 ``row_gather``, K21 ``smem_gather`` and the P6 pair
(``kernels.shard_scatter``: K1 in table mode, K20 as its VJP), by their
plain versions, against the JAX package's per-shard stripe scatter
``make_traced_scatter_add`` (its Pallas calls in interpret mode) and the
oracles the TPU probes check themselves with (``table[row]``,
``segment_sum``, ``np.asarray(tab)[idx]``); and the probe entry point's
refusal without a card.

The JAX scatter and gather run in float32 (``vals_dtype=float32``, the
sharded stripe spmm's default); they are held at the JAX package's own
tolerance for them, 2e-2 of scale (``test_multichip.py``), and the measured
difference is printed. The probe scripts run their benchmarks at import
time and are not imported; their oracles are written out here.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_pde_tpu.ops.pallas.stripe import (build_stripe_plan,
                                                    make_traced_scatter_add)
from graph_neural_pde_tpu_torch import kernels
from graph_neural_pde_tpu_torch.kernels import (ScatterPlan, csr_spmm,
                                                row_gather, row_gather_plain,
                                                shard_scatter, smem_gather,
                                                smem_gather_plain)
from graph_neural_pde_tpu_torch.kernels.smem_gather import (table_fits,
                                                            width_fits)
from graph_neural_pde_tpu_torch.probes import gather as probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIPE = 2e-2
N, E = 60, 500


@pytest.fixture(autouse=True, scope="module")
def _single_torch_thread():
    """The suite runs several workers at once: torch's intra-op thread pool
    only spins against theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def rank_rows(rank: int, world: int = 4, seed: int = 0):
    """Rank ``rank``'s slice of a row-sorted random edge list, cut at the
    sharded stripe spmm's ``np.linspace`` bounds (rows straddle ranks)."""
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, N, E)).astype(np.int32)
    b = np.linspace(0, E, world + 1).astype(int)
    return row[b[rank]:b[rank + 1]]


@pytest.mark.parametrize("d", [8, 130])
@pytest.mark.parametrize("rank", [0, 3])
def test_shard_scatter_matches_traced_scatter_add(rank, d):
    """One rank of a 4-way split: the forward (P6's ``_call``) and its VJP
    (P6's ``_gather_call``) against the JAX op in interpret mode, with the
    JAX plan's slots mapped onto the port's edges (``slot_of_edge``)."""
    rows = rank_rows(rank)
    rng = np.random.default_rng(rank + d)
    vals = rng.normal(size=(rows.shape[0], d)).astype(np.float32)
    jp = build_stripe_plan(rows, num_nodes=N, block_n=8, chunk=16)
    slot_vals = np.zeros((jp.capacity, d), np.float32)
    slot_vals[jp.slot_of_edge] = vals
    scatter = make_traced_scatter_add(8, jp.chunk, jp.num_nodes,
                                      vals_dtype=jnp.float32)
    rl, cr = jnp.asarray(jp.row_local), jnp.asarray(jp.chunk_rows)
    out_j, vjp = jax.vjp(lambda v: scatter(rl, cr, v),
                         jnp.asarray(slot_vals))
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    grad_j = np.asarray(vjp(jnp.asarray(ct))[0])[jp.slot_of_edge]

    plan = ScatterPlan.from_rows(rows, N)
    v = torch.tensor(vals, requires_grad=True)
    out = shard_scatter(plan, v)
    out.backward(torch.tensor(ct[:N]))
    fwd = rel_err(out.detach(), np.asarray(out_j)[:N])
    bwd = rel_err(v.grad, grad_j)
    print(f"rank {rank} D={d}: forward {fwd:.2e}, gather {bwd:.2e} of scale "
          f"against make_traced_scatter_add")
    assert fwd <= STRIPE and bwd <= STRIPE
    # the oracles: segment sums of the payload and ct[row]
    seg = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(rows),
                              num_segments=N, indices_are_sorted=True)
    assert rel_err(out.detach(), seg) <= 1e-5
    np.testing.assert_array_equal(v.grad.numpy(), ct[:N][rows])


def test_plan_rowptr_is_the_clamped_rowptr():
    """A rank's row pointer is the whole list's, clamped to its slice."""
    rng = np.random.default_rng(0)
    row = np.sort(rng.integers(0, N, E)).astype(np.int32)
    whole = ScatterPlan.from_rows(row, N).rowptr.numpy()
    b = np.linspace(0, E, 5).astype(int)
    for r in range(4):
        plan = ScatterPlan.from_rows(row[b[r]:b[r + 1]], N)
        np.testing.assert_array_equal(
            plan.rowptr.numpy(), np.clip(whole, b[r], b[r + 1]) - b[r])
        assert plan.n_valid == b[r + 1] - b[r]
        assert plan.valid.tolist() == [1.0] * plan.n_valid
        assert plan.slots.tolist() == list(range(plan.n_valid))
    with pytest.raises(ValueError, match="sorted"):
        ScatterPlan.from_rows(row[::-1], N)


def test_row_gather_is_table_row_with_a_zero_tail():
    """Probe 1's gather oracle ``table[row]``, over a valid prefix with
    padding slots after it."""
    rows = rank_rows(1)
    plan = ScatterPlan.from_rows(rows, N)
    padded_rows = torch.cat([plan.row, torch.zeros(7, dtype=torch.int32)])
    table = np.random.default_rng(1).normal(size=(N, 5)).astype(np.float32)
    got = row_gather(plan.rowptr, padded_rows, torch.tensor(table)).numpy()
    np.testing.assert_array_equal(got[:rows.shape[0]], table[rows])
    assert got.shape[0] == rows.shape[0] + 7 and not got[rows.shape[0]:].any()
    np.testing.assert_array_equal(
        row_gather_plain(plan.rowptr, padded_rows,
                         torch.tensor(table)).numpy(), got)


@pytest.mark.parametrize("bad", ["dtype", "rowptr", "index dtype"])
def test_row_gather_rejects(bad):
    plan = ScatterPlan.from_rows(rank_rows(0), N)
    table = torch.zeros((N, 4))
    args = dict(dtype=(plan.rowptr, plan.row, table.double()),
                rowptr=(plan.rowptr[:-1], plan.row, table),
                **{"index dtype": (plan.rowptr.long(), plan.row, table)})[bad]
    with pytest.raises((TypeError, ValueError)):
        row_gather(*args)


def test_k1_table_mode_is_the_sorted_segment_sum():
    """Probe 1's B: K1 in table mode over a row-sorted payload is
    ``segment_sum(vals, row, indices_are_sorted=True)``."""
    rows = rank_rows(0, world=1)
    vals = np.random.default_rng(2).normal(size=(E, 258)).astype(np.float32)
    plan = ScatterPlan.from_rows(rows, N)
    got = csr_spmm(plan.rowptr, plan.row, plan.slots, plan.valid,
                   torch.tensor(vals), table=True)
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(rows),
                               num_segments=N, indices_are_sorted=True)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("t_rows, dtype", [(8, torch.float32),
                                           (64, torch.float32),
                                           (448, torch.float32),
                                           (512, torch.bfloat16)])
def test_smem_gather_is_the_probe_oracle(t_rows, dtype):
    """Probe 13's oracle ``np.asarray(tab)[idx]``, bit for bit, in the
    table's dtype."""
    rng = np.random.default_rng(t_rows)
    tab = torch.tensor(rng.normal(size=(t_rows, 128)).astype(np.float32)
                       ).to(dtype)
    idx = rng.integers(0, t_rows, 4_096).astype(np.int32)
    got = smem_gather(torch.tensor(idx), tab)
    assert got.dtype == dtype and got.shape == (4_096, 128)
    np.testing.assert_array_equal(got.float().numpy(),
                                  tab.float().numpy()[idx])
    assert torch.equal(smem_gather_plain(torch.tensor(idx), tab), got)


def test_smem_gather_table_limit():
    """Which of the probe's tables a block's 227 KB of shared memory
    holds: float32 up to 448 rows of 128, bfloat16 512 (the wrapper raises
    on a CUDA table that does not fit)."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert table_fits(torch.zeros((448, 128), dtype=f32))
    assert not table_fits(torch.zeros((512, 128), dtype=f32))
    assert table_fits(torch.zeros((512, 128), dtype=bf16))
    with pytest.raises(TypeError, match="int32"):
        smem_gather(torch.zeros(4, dtype=torch.int64), torch.zeros((8, 4)))
    with pytest.raises(TypeError, match="bfloat16"):
        smem_gather(torch.zeros(4, dtype=torch.int32),
                    torch.zeros((8, 4), dtype=torch.float64))


@pytest.mark.parametrize("d, dtype, fits", [
    (128, torch.float32, True), (128, torch.bfloat16, True),
    (4, torch.float32, True), (130, torch.float32, False),
    (24, torch.float32, False), (4, torch.bfloat16, False)])
def test_smem_gather_widths(d, dtype, fits):
    """The kernel copies rows of whole 16-byte words that divide its 512
    threads (the probe's D = 128 in both dtypes); the wrapper refuses any
    other width on a CUDA table rather than run an unchecked copy."""
    assert width_fits(torch.zeros((8, d), dtype=dtype)) is fits


def test_cpu_wrappers_launch_nothing():
    before = [k.launches for k in kernels.KERNELS]
    plan = ScatterPlan.from_rows(rank_rows(2), N)
    v = torch.ones((plan.row.shape[0], 3), requires_grad=True)
    shard_scatter(plan, v).sum().backward()
    smem_gather(torch.zeros(4, dtype=torch.int32), torch.ones((8, 4)))
    assert [k.launches for k in kernels.KERNELS] == before
    for k in (kernels.row_gather, kernels.smem_gather):
        assert k in kernels.KERNELS


def test_probe_edges_are_the_tpu_probes():
    """``perf_probe1.py``'s draw: sorted uniform rows, then uniform
    columns, from one generator."""
    row, col = probes.probe1_edges(0)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        row, np.sort(rng.integers(0, probes.N, size=probes.E1)))
    np.testing.assert_array_equal(
        col, rng.integers(0, probes.N, size=probes.E1))
    assert (probes.N, probes.E1, probes.E13) == (169_343, 2_332_486,
                                                 2_703_360)


def test_probe_entry_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.main([])
    proc = subprocess.run(
        [sys.executable, "-m", "graph_neural_pde_tpu_torch.probes.gather"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and not proc.stdout
    assert "no CUDA device" in proc.stderr
