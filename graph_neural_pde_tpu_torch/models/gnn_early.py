"""GNNEarly: the GNN whose test-time integrator scores every accepted step
(PyTorch port of ``models/gnn_early.py``).

At evaluation the ODE block integrates to ``earlystopxT · T`` with the
early-stop solver, decoding the state with relu → m2 after every accepted
step and keeping the best-validation snapshot and its diffusion time t*.
Training is the plain GNN's.
"""

from __future__ import annotations

import torch

from graph_neural_pde_tpu_torch.models.blocks import (build_aux,
                                                      solved_badly)
from graph_neural_pde_tpu_torch.models.functions import (make_rhs,
                                                         rhs_may_poison)
from graph_neural_pde_tpu_torch.models.gnn import GNNModel
from graph_neural_pde_tpu_torch.solvers.api import SolverOptions
from graph_neural_pde_tpu_torch.solvers.early_stop import odeint_early_stop
from graph_neural_pde_tpu_torch.training.train import accuracy


class GNNEarlyModel(GNNModel):

    @torch.no_grad()
    def apply_early(self, x, y, masks):
        """Evaluation forward with in-integrator model selection.

        y: int labels [N]; masks: (train_mask, val_mask, test_mask).
        Returns (logits at the extended T, best: BestSnapshot, stats).
        """
        cfg = self.cfg
        x0 = self.encode(x, False)
        aux, _ = build_aux(self.block, cfg, self.graph, x0, training=False)
        train_mask, val_mask, test_mask = masks

        def evaluate(z):
            # relu -> m2 only: the early-stop evaluator ignores dropout
            # (reference early_stop_solver.py:105-122)
            logits = self.m2(torch.relu(z))
            return (accuracy(logits, y, train_mask),
                    accuracy(logits, y, val_mask),
                    accuracy(logits, y, test_mask))

        t_ext = cfg.earlystopxT * cfg.time

        def solve(exact_softmax: bool):
            rhs = make_rhs(cfg, self.graph, spmm_fn=self.spmm_fn,
                           exact_softmax=exact_softmax)
            return odeint_early_stop(
                lambda t, yy: rhs(self.block.func, aux, t, yy), x0, 0.0,
                float(t_ext), SolverOptions.from_config(cfg), evaluate,
                max_test_steps=cfg.max_test_steps)

        zT, best, stats = solve(False)
        # the fused transformer RHS poisons on softmax under/overflow (see
        # block_forward): re-run once with the exact per-row softmax
        if rhs_may_poison(cfg) and solved_badly(zT, stats):
            zT, best, stats = solve(True)
        return self.decode(zT, False), best, stats
