"""ODE right-hand sides dx/dt = f(x(t), G) (PyTorch port of the
laplacian, transformer and GAT functions of ``models/functions.py``).

``make_rhs`` returns ``rhs(func, aux, t, x)`` where ``func`` holds the
learnable parameters and ``aux`` the per-solve constants. Ported: the
laplacian function (every tuned GRAND-l config), the transformer function
(GRAND-nl: attention recomputed at every evaluation; softmax or squareplus,
optionally reweighted by the adjacency, with or without ``mix_features``)
and the GAT function. With column normalisation
(``attention_norm_idx=1``) the transformer function's plain softmax runs on
the fused column-normalised kernels (K12-K14) over a symmetric edge
multiset. Every function runs on directed graphs too (GDC, two-hop): their
column-side passes walk the graph's CSC view. BLEND's split-space attention
(``models.attention.is_beltrami``) runs in every fused engine as the score
family ``exp_kernel_beltrami`` over the block-structured projections of
:func:`pack_beltrami`, and in every composition as its own scores.

``rhs_payload_dtype="bfloat16"`` (:func:`payload_dtype`) makes the
laplacian's aggregation (K1/K2), the transformer's plain row softmax
(K6-K9 and K17: ``make_fused_ax_sym``, ``make_fused_ax_colplan`` on a
directed graph or with ``sym_backward=False``, ``fused_rhs_f``, and the
exact re-solve's ``fused_rowmax`` and ``fused_rhs_ax``), its plain
softmax over the columns of a symmetric graph at widths up to 128
(K12-K14: ``make_fused_ax_norm1``) and the composed row RHS of the
transformer and GAT functions (squareplus, reweighted attention, a
re-masked graph, the exact re-solve of the other families: k or s_dst
from the bf16 table and K10/K11 over it) read their gathered column tables
in bfloat16, where the JAX package sets its ``pay_dt``; the bfloat16 state
reads its own x there. The composed routes without the fused aggregate
(``mix_features``, ``fused_attention_agg=False``, the softmax over columns
outside ``norm1_fused_ok`` and its exact re-solve, a directed or re-masked
graph over columns) apply no payload, as the JAX package's composition
does, and widen a bfloat16 state where JAX's type promotion widens it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, List, NamedTuple, Optional

import torch
from torch import nn

from graph_neural_pde_tpu_torch.config import Config
from graph_neural_pde_tpu_torch.kernels.dual_scatter import dual_scatter_add
from graph_neural_pde_tpu_torch.kernels.fused_rhs import (
    SCORES, column_table, den_guard, fused_rhs_ax, fused_rhs_f, fused_rowmax,
    make_fused_ax_colplan, make_fused_ax_sym)
from graph_neural_pde_tpu_torch.kernels.norm1 import make_fused_ax_norm1
from graph_neural_pde_tpu_torch.models.attention import (
    GATAttention, TransformerAttention, apply_gat_attention,
    apply_transformer_attention, gat_scores, is_beltrami, score_family,
    score_params, transformer_scores, widen_state)
from graph_neural_pde_tpu_torch.ops.graph import Graph
from graph_neural_pde_tpu_torch.ops.scatter import global_max, segment_softmax
from graph_neural_pde_tpu_torch.ops.spmm import (make_spmm, spmm_mean_heads,
                                                 spmm_multihead)


class FuncAux(NamedTuple):
    """Per-solve constants.

    attention  : [E] head-mean frozen attention (attention block), the
                 renormalised sampled attention (hard_attention block) or
                 None
    x0         : source-term state, detached (the reference's set_x0 clones
                 and detaches, base_classes.py:52-54)
    edge_weight: normalised adjacency weights
    """

    attention: Optional[torch.Tensor]
    x0: torch.Tensor
    edge_weight: torch.Tensor


class FuncParams(NamedTuple):
    """An ODE function's parameters as plain tensors, where a solver passes
    them explicitly (the continuous adjoint); the RHS reads them from this
    or from an ``ODEFunc`` alike. ``att`` mirrors ``ODEFunc.att``: ``Q.w``,
    ``K.b``, ``output_var`` ... for the transformer function, ``W``,
    ``Wout``, ``a`` for the GAT function."""

    alpha_train: torch.Tensor
    beta_train: torch.Tensor
    att: Optional[SimpleNamespace] = None


class ODEFunc(nn.Module):
    """alpha_train / beta_train scalars, initialised to 0 (reference
    base_classes.py:87-88), plus the attention layer ``att`` of the
    transformer and GAT functions, which recompute attention at every
    evaluation (the JAX package's ``init_func_params``)."""

    def __init__(self, cfg: Config, in_dim: int = 0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_function(cfg)
        self.alpha_train = nn.Parameter(torch.zeros(()))
        self.beta_train = nn.Parameter(torch.zeros(()))
        if cfg.function == "transformer":
            self.att = TransformerAttention(cfg, in_dim, generator=generator)
        elif cfg.function == "GAT":
            self.att = GATAttention(cfg, in_dim, generator=generator)


# the GAT layer's leaves, and the transformer attention layer's linear maps
# and scalars, in the JAX package's leaf order (a dict pytree flattens by
# sorted key)
_GAT_LEAVES = ("W", "Wout", "a")
_ATT_MAPS = ("K", "Q", "V", "Wout")
_BELTRAMI_MAPS = ("Kp", "Kx", "Qp", "Qx", "Vp", "Vx", "Wout")
_ATT_SCALARS = ("lengthscale", "lengthscale_p", "lengthscale_x",
                "output_var", "output_var_p", "output_var_x")


def _is_gat(att) -> bool:
    return hasattr(att, "a")


def _att_layout(att):
    """(linear maps, scalars) of a transformer attention layer."""
    maps = _BELTRAMI_MAPS if hasattr(att, "Qx") else _ATT_MAPS
    return maps, tuple(n for n in _ATT_SCALARS if hasattr(att, n))


def func_tensors(func: ODEFunc, inert: torch.Tensor) -> List[torch.Tensor]:
    """Every tensor of the function's parameters in the JAX package's leaf
    order: the inert probe scalar (``inert`` stands in for it), alpha, the
    attention layer's leaves, beta. :func:`func_from_tensors` inverts it."""
    out = [inert, func.alpha_train]
    att = getattr(func, "att", None)
    if att is not None and _is_gat(att):
        out += [getattr(att, leaf) for leaf in _GAT_LEAVES]
    elif att is not None:
        maps, scalars = _att_layout(att)
        out += [getattr(getattr(att, m), leaf) for m in maps
                for leaf in ("b", "w")]
        out += [getattr(att, n) for n in scalars]
    return out + [func.beta_train]


def func_from_tensors(func: ODEFunc, tensors) -> FuncParams:
    """The ``FuncParams`` over ``tensors``, laid out as :func:`func_tensors`
    lays out ``func``."""
    att = None
    if getattr(func, "att", None) is not None and _is_gat(func.att):
        att = SimpleNamespace(**dict(zip(_GAT_LEAVES, tensors[2:-1])))
    elif getattr(func, "att", None) is not None:
        maps, scalars = _att_layout(func.att)
        rest = iter(tensors[2:-1])
        att = SimpleNamespace()
        for m in maps:
            setattr(att, m, SimpleNamespace(b=next(rest), w=next(rest)))
        for n in scalars:
            setattr(att, n, next(rest))
    return FuncParams(tensors[1], tensors[-1], att)


def _alpha(cfg: Config, func) -> torch.Tensor:
    a = func.alpha_train
    return a if cfg.no_alpha_sigmoid else torch.sigmoid(a)


def _source(cfg: Config, func, f: torch.Tensor, aux: FuncAux):
    if cfg.add_source:
        return f + func.beta_train * aux.x0
    return f


# the widest state the JAX package's column-softmax engine takes (its
# ``make_rhs`` composes above it, without the payload)
NORM1_PAYLOAD_MAX_DIM = 128


def payload_dtype(cfg: Config) -> Optional[torch.dtype]:
    """The dtype of the gathered column tables: ``torch.bfloat16`` for
    ``rhs_payload_dtype="bfloat16"`` (the JAX package's ``pay_dt``), else
    None (the state's own dtype)."""
    return torch.bfloat16 if cfg.rhs_payload_dtype == "bfloat16" else None


def table_dtype(cfg: Config, x: torch.Tensor) -> Optional[torch.dtype]:
    """The dtype the attention RHS's gathered column table is read in, as
    the JAX package sets pay_dt: the bf16 payload, or a bf16 state's own;
    None for x as it is."""
    return payload_dtype(cfg) or (torch.bfloat16
                                  if x.dtype == torch.bfloat16 else None)


def laplacian_payload(cfg: Config) -> Optional[torch.dtype]:
    """The payload dtype of the SpMM engine (K1/K2): the JAX package routes
    its bf16 payload through the laplacian aggregation only."""
    return payload_dtype(cfg) if cfg.function == "laplacian" else None


def fused_attention(cfg: Config) -> bool:
    """True when the transformer or GAT RHS folds the row normalisation
    into the aggregation (K6-K9 for the transformer's plain softmax,
    K10/K11 otherwise) rather than composing attention and SpMM."""
    return (cfg.function in ("transformer", "GAT")
            and cfg.fused_attention_agg and not cfg.mix_features
            and cfg.attention_norm_idx == 0)


def norm1_fused_ok(cfg: Config) -> bool:
    """True when the column-normalised (``attention_norm_idx=1``)
    transformer RHS runs on the fused kernels K12-K14
    (``kernels.norm1.make_fused_ax_norm1``): the plain softmax of one of
    the four in-kernel score families (and BLEND's split-space score).
    ``make_rhs`` still sends the exact re-solve, a re-masked graph and a
    directed graph (no ``rev``: the JAX package asks for a symmetric plan)
    to the composition. The JAX package's predicate also asks for its
    bfloat16 payload, without which it composes; the port runs K12-K14 in
    float32 there, and in their bf16 mode under the payload or the bf16
    state at widths up to 128 (``_transformer_rhs_fused``)."""
    return (cfg.fused_attention_agg and not cfg.mix_features
            and cfg.attention_norm_idx == 1
            and cfg.function == "transformer"
            and cfg.attention_type in SCORES
            and not cfg.square_plus and not cfg.reweight_attention)


def check_function(cfg: Config) -> None:
    if cfg.function not in ("laplacian", "transformer", "GAT"):
        raise ValueError(f"unknown function '{cfg.function}'")
    if cfg.function == "transformer" and cfg.mix_features and is_beltrami(cfg):
        # the reference's split-space layer returns no values to mix
        raise ValueError("mix_features takes no Beltrami attention (its "
                         "layer has no value projection to aggregate)")


def pack_beltrami(att, cfg: Config, d: int):
    """(qw, qb, kw, kb) of the fused kernels for BLEND's split-space
    attention over a state of width ``d`` laid out as [features | positions
    | labels]: the block-structured [D, 2 ATT] projections whose columns
    [0, ATT) map the features and labels through Qx (Kx) and columns
    [ATT, 2 ATT) the positions through Qp (Kp), zero elsewhere, so that
    ``x qw + qb`` is (Qx x_feat ‖ Qp x_pos), as ``_pack_proj`` of the JAX
    package builds it. Differentiable in the six tensors it reads."""
    fh = cfg.feat_hidden_dim
    li = fh + cfg.pos_enc_hidden_dim

    def pack(px, pp):
        ad = px.w.shape[1]
        left = torch.cat([px.w[:fh], px.w.new_zeros((li - fh, ad)),
                          px.w[fh:]], 0)
        right = torch.cat([pp.w.new_zeros((fh, ad)), pp.w,
                           pp.w.new_zeros((d - li, ad))], 0)
        return torch.cat([left, right], 1), torch.cat([px.b, pp.b])

    return (*pack(att.Qx, att.Qp), *pack(att.Kx, att.Kp))


def _projections(att, cfg: Config, d: int):
    """(qw, qb, kw, kb) the fused kernels take."""
    if is_beltrami(cfg):
        return pack_beltrami(att, cfg, d)
    return att.Q.w, att.Q.b, att.K.w, att.K.b


def _mega_ok(cfg: Config, g: Graph, exact_softmax: bool) -> bool:
    """True when the fused transformer RHS runs as one kernel (K6-K9): the
    plain softmax over the whole graph. Squareplus differentiates through
    its global max, reweighting multiplies the scores by a per-edge weight
    and a re-masked graph drops edges inside the rows, none of which those
    kernels take; the exact mode's row-max shifts exist for scaled_dot
    only (the other families are bounded). All of these compose the scores
    with torch ops and aggregate on K10/K11."""
    return not (cfg.square_plus or cfg.reweight_attention or g.masked
                or (exact_softmax and cfg.attention_type != "scaled_dot"))


def _transformer_rhs_fused(func, aux: FuncAux, x: torch.Tensor, cfg: Config,
                           g: Graph, exact_softmax: bool, eval_fold: bool):
    """GRAND-nl RHS with the normalisation folded into the aggregation.

    Over columns (``norm1_fused_ok``) the plain softmax is K12 and K13 per
    evaluation, K12 and K14 for its gradient, with the same unshifted exp
    and NaN poison as below; its exact re-solve is the composition in
    ``make_rhs``. The rest of this is the normalisation over rows.

    The plain softmax (``_mega_ok``) is one K6 launch per evaluation. Its
    gradient is K9 when ``cfg.sym_backward`` (default on) and the edge
    multiset is symmetric, otherwise K8 without its per-edge array and K17
    over the CSC view (``make_fused_ax_colplan``), as the JAX package
    chooses (its column-plan backward). Softmax is shift-invariant, so exp
    runs unshifted (``gmax = 0``), exact while the scores stay within
    float32's exp range. Both failure modes, a whole row underflowing to 0
    or a score overflowing to inf, poison the output with NaN;
    ``block_forward`` then re-solves once with ``exact_softmax``, which
    shifts every edge by its row's true score max (K7) so that no exp can
    leave the range; its gradient is K8 with the per-edge dxg, summed over
    columns by K1. Every one of these kernels (K12-K14 at widths up to 128)
    reads the bfloat16 column table under the bf16 payload or state, where
    the JAX package passes its ``pay_dt``.

    Every other variant composes: per-head scores from the gathered q[row]
    and k[col], the global max ``gmax`` (differentiated through, as the
    reference's squareplus is), ``u`` by squareplus or exp, then numerators
    and denominators in one pass (K10, gradient K11). Under the bf16
    payload or state, k comes from the bf16 table as the JAX package
    rounds it (``transformer_scores``) and K10/K11 read that table; u and
    every sum stay float32, as the JAX package's XLA aggregate keeps them
    (its stripe kernels round u and the products too)."""
    att = func.att
    h, score = cfg.heads, score_family(cfg)
    sp = score_params(att, cfg)
    pay = table_dtype(cfg, x)
    if cfg.attention_norm_idx == 1:
        # the softmax over columns (``norm1_fused_ok`` on a symmetric edge
        # multiset; make_rhs sends no other column-normalised config here):
        # K12 and K13, unshifted like the row softmax, with the same guard
        # over the COLUMN denominators, so against the column degrees. The
        # JAX package's engine takes widths up to 128 and composes above,
        # without the payload: there the column table is x itself (a
        # bfloat16 state's in float32)
        if x.shape[1] > NORM1_PAYLOAD_MAX_DIM:
            pay = None
            x = widen_state(x)
        gmax = torch.zeros((1,), dtype=torch.float32, device=x.device)
        ax, den = make_fused_ax_norm1(g, h, False, score, pay)(
            *_projections(att, cfg, x.shape[1]), x, gmax, sp)
        bad = den_guard(den, g.colptr, per_row=False)
        ax = torch.where(bad, torch.full_like(ax, torch.nan), ax)
        return _source(cfg, func, _alpha(cfg, func) * (ax - x), aux)
    if not _mega_ok(cfg, g, exact_softmax):
        prods = transformer_scores(att, cfg, x, g, aux.edge_weight,
                                   payload=pay).float()
        if cfg.square_plus:
            sm = prods - global_max(prods, g.mask)
            u = (sm + torch.sqrt(sm * sm + 4.0)) / 2.0
            u = torch.where(g.mask[:, None], u, torch.zeros_like(u))
            ax = _fused_normalized_aggregate(cfg, g, u, x, pay)
        else:
            ax = _softmax_aggregate_guarded(cfg, g, prods, x, exact_softmax,
                                            pay)
        return _source(cfg, func, _alpha(cfg, func) * (ax - x), aux)
    qw, qb, kw, kb = _projections(att, cfg, x.shape[1])
    if eval_fold and not exact_softmax:
        f = fused_rhs_f(g, h, score, qw, qb, kw, kb, x, _alpha(cfg, func), sp,
                        payload_dtype=pay)
        return _source(cfg, func, f, aux)
    gmax = torch.zeros((1,), dtype=torch.float32, device=x.device)
    use_sym = cfg.sym_backward if cfg.sym_backward is not None else True
    if use_sym and g.rev is not None and not exact_softmax:
        ax, den = make_fused_ax_sym(g, h, False, score, pay)(qw, qb, kw, kb,
                                                             x, gmax, sp)
    elif not exact_softmax:
        ax, den = make_fused_ax_colplan(g, h, False, score, pay)(
            qw, qb, kw, kb, x, gmax, sp)
    else:
        with torch.no_grad():
            xc = x.contiguous()
            smax = fused_rowmax(g.rowptr, g.row, g.col, xc, qw, qb, kw, kb,
                                heads=h, xcol=column_table(xc, pay),
                                pieces=g.row_pieces)
            shifts = smax[g.row.long()]
        ax, den = fused_rhs_ax(g, h, False, score, qw, qb, kw, kb, x, gmax,
                               shifts, sp, payload_dtype=pay)
    if not exact_softmax:
        bad = den_guard(den, g.rowptr, per_row=False)
        ax = torch.where(bad, torch.full_like(ax, torch.nan), ax)
    f = _alpha(cfg, func) * (ax - x)
    return _source(cfg, func, f, aux)


def _softmax_aggregate_guarded(cfg: Config, g: Graph, prods: torch.Tensor,
                               x: torch.Tensor, exact_softmax: bool,
                               payload: Optional[torch.dtype] = None):
    """Softmax aggregation of raw scores ``prods`` [E, H], exact up to a
    NaN-poisoned underflow escape.

    The fast path substitutes ONE global max for the per-row softmax maxima:
    the same result unless an exp underflows to 0 on a valid edge (its score
    ~88 below the global max), which poisons the whole output with NaN, by
    a device ``any`` and a select, never a host sync; ``block_forward``
    detects it after the solve and re-solves with ``exact_softmax``, the
    per-row softmax (K3) fed to the same aggregate. ``payload`` as
    :func:`_fused_normalized_aggregate` takes it."""
    m = g.mask[:, None]
    if exact_softmax:
        att = segment_softmax(prods, g, 0)
        att = torch.where(m, att, torch.zeros_like(att))
        return _fused_normalized_aggregate(cfg, g, att, x, payload)
    u = torch.exp(prods - global_max(prods, g.mask))
    u = torch.where(m, u, torch.zeros_like(u))
    underflowed = torch.any((u == 0.0) & m)
    ax = _fused_normalized_aggregate(cfg, g, u, x, payload)
    return torch.where(underflowed, torch.full_like(ax, torch.nan), ax)


def _fused_normalized_aggregate(cfg: Config, g: Graph, u: torch.Tensor,
                                x: torch.Tensor,
                                payload: Optional[torch.dtype] = None
                                ) -> torch.Tensor:
    """Shared tail of the composed paths: per-head numerators and
    denominators from one aggregation pass (K10), then the mean over heads
    of ``num_h / (den_h + 1e-16)``. ``u`` [E, H] is unnormalised, positive
    and 0 on masked and padding slots. ``payload`` (``torch.bfloat16``) is
    the dtype K10/K11 read x[col] in; the result is float32."""
    h, d = cfg.heads, x.shape[1]
    num, den = dual_scatter_add(g, u, x, payload)
    recip = 1.0 / (den + 1e-16)
    out = num[:, :d] * recip[:, 0:1]
    for hh in range(1, h):
        out = out + num[:, hh * d:(hh + 1) * d] * recip[:, hh:hh + 1]
    return out * (1.0 / h)


def _gat_rhs_fused(func, aux: FuncAux, x: torch.Tensor, cfg: Config,
                   g: Graph, exact_softmax: bool):
    """GAT RHS with separable scores (``models.attention.gat_scores``) and
    the softmax folded into the aggregation (K10/K11). GAT never takes
    squareplus: the exp path and its poison guard run whatever
    ``cfg.square_plus`` says. Under the bf16 payload or state ``s_dst`` and
    the aggregate read the bf16 table, as the JAX package's ``pay_dt``."""
    pay = table_dtype(cfg, x)
    scores, _ = gat_scores(func.att, cfg, x, g, payload=pay)
    ax = _softmax_aggregate_guarded(cfg, g, scores.float(), x, exact_softmax,
                                    pay)
    return _source(cfg, func, _alpha(cfg, func) * (ax - x), aux)


def rhs_may_poison(cfg: Config) -> bool:
    """True when make_rhs's default path can NaN-poison its output on
    softmax under- or overflow, so that the caller must re-solve with
    ``make_rhs(..., exact_softmax=True)`` if the solved state is not
    finite: the fused softmax over rows or (``norm1_fused_ok``) over
    columns. The fused GAT RHS always runs exp, so it can poison with
    ``square_plus`` set too (the JAX package's ``rhs_may_poison`` answers
    False there and leaves the NaN standing)."""
    if fused_attention(cfg):
        return cfg.function == "GAT" or not cfg.square_plus
    return norm1_fused_ok(cfg)


def make_rhs(cfg: Config, g: Graph, spmm_fn: Optional[Callable] = None,
             exact_softmax: bool = False,
             eval_fold: bool = False) -> Callable:
    """Build rhs(func, aux, t, x) for cfg.function over the prepared graph.

    * laplacian: alpha·(A_w x − x) [+ beta·x0] with A_w the frozen attention
      (or the normalised adjacency).
    * transformer: A_w is the head-mean attention recomputed from x. With
      row normalisation it is the fused RHS (K6-K9 and K17, or the scores
      composed and aggregated on K10/K11, see ``_transformer_rhs_fused``),
      with the plain softmax over the columns of a symmetric graph the
      fused K12-K14 (``norm1_fused_ok``); otherwise (the other
      column-normalised variants and graphs, ``fused_attention_agg=False``
      or ``mix_features``) attention (K3/K4) and SpMM (K1/K2) are composed.
      ``mix_features`` aggregates the per-head values V x and maps their
      head mean back through Wout.
    * GAT: the same with the GAT layer's scores (``_gat_rhs_fused`` on
      K10/K11, or the composition); ``mix_features`` aggregates W x and maps
      it back through Wout.

    ``spmm_fn(x, w)`` is the aggregation engine, by default
    ``ops.spmm.make_spmm(g)``: the CUDA kernels on a CUDA graph, their plain
    versions on a CPU one. ``g`` may be re-masked (``Graph.with_mask``):
    dropped edges take no attention. ``exact_softmax`` normalises with the
    exact per-row softmax instead of the global-shift fast path (see
    ``rhs_may_poison``). ``eval_fold`` folds alpha·(ax − x) and a per-row
    guard into K6's final write on no-grad solves."""
    check_function(cfg)
    if spmm_fn is None:
        spmm_fn = make_spmm(g, laplacian_payload(cfg))

    if cfg.function == "laplacian":

        def rhs(func, aux: FuncAux, t, x):
            w = aux.attention if aux.attention is not None else aux.edge_weight
            ax = spmm_fn(x, w)
            f = _alpha(cfg, func) * (ax - x)
            return _source(cfg, func, f, aux)

        return rhs

    use_fused = fused_attention(cfg)

    if cfg.function == "transformer":
        # the column softmax is fused for the fast solve over the whole of
        # a symmetric graph only: the exact re-solve, a re-masked graph and
        # a directed graph compose (K3/K4 over the columns)
        use_fused = use_fused or (norm1_fused_ok(cfg) and not exact_softmax
                                  and not g.masked and g.rev is not None)

        def rhs(func, aux: FuncAux, t, x):
            if use_fused:
                return _transformer_rhs_fused(func, aux, x, cfg, g,
                                              exact_softmax, eval_fold)
            att = func.att
            # no payload here, as in the JAX package's composition; a
            # bfloat16 state is projected in float32, as its type promotion
            # widens it, and the aggregation reads it as it is (K1 on the
            # bf16 table)
            xw = widen_state(x)
            attention = apply_transformer_attention(
                att, cfg, xw, g, edge_weight=aux.edge_weight)
            if cfg.mix_features:
                v = (xw @ att.V.w + att.V.b).reshape(x.shape[0], cfg.heads,
                                                     -1)
                vx = torch.mean(spmm_multihead(g, attention, v, spmm_fn),
                                dim=1)                           # [N, d_k]
                ax = vx @ att.Wout.w + att.Wout.b
            else:
                ax = spmm_mean_heads(g, attention, x, spmm_fn)
            f = _alpha(cfg, func) * (ax - x)
            return _source(cfg, func, f, aux)

        return rhs

    def rhs(func, aux: FuncAux, t, x):
        if use_fused:
            return _gat_rhs_fused(func, aux, x, cfg, g, exact_softmax)
        attention, wx = apply_gat_attention(func.att, cfg, x, g)
        # GAT aggregates the SAME value matrix under every head, and spmm is
        # linear in the weights: one spmm with the head-mean attention
        mean_att = torch.mean(attention, dim=1)
        if cfg.mix_features:
            ax = spmm_fn(wx, mean_att) @ func.att.Wout
        else:
            ax = spmm_fn(x, mean_att)
        f = _alpha(cfg, func) * (ax - x)
        return _source(cfg, func, f, aux)

    return rhs
