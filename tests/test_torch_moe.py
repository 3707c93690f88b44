"""The MoE family (``repro_torch.models.moe`` and the transformer's MoE
branches) against the reference's ``repro.models.moe`` on the CPU.

qwen3-moe-30b-a3b and llama4-scout-17b-a16e at ``reduced()`` (4 experts,
top-2 and top-1; f32), the reference's parameters carried across by
``interop.params_from_repro``, inputs drawn with numpy from a seed.
Tolerances:

* routing (the top-k expert ids) and the kept/dropped assignment set, and
  the whole slot layout, equal the reference's; each case asserts that its
  inputs keep the K-th and (K+1)-th probabilities at least ``MIN_GAP``
  apart, so the equality is well posed;
* the combine-back and the dispatch gather's backward equal the
  reference's scatter-add bit for bit on the same inputs (both add a
  token's slots in ascending slot order);
* ``moe_ffn``'s output within rtol = atol = 1e-5 and the load-balance loss
  within 1e-6 (the expert products are ``torch.bmm`` against XLA's
  einsum: the same f32 operations in another order); gradients of a
  scalar of both within rtol 1e-4, atol 1e-5, as the dense training tests;
* the model: hidden states and logits within 1e-5, prefill and decode
  logits within 1e-4 (the serve tests' f32 tolerance), the loss within
  rtol 1e-5, three train steps within rtol 1e-4 (loss, grad_norm) and
  atol 1e-5 (master parameters), as ``test_torch_training.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import serve_step as jserve  # noqa: E402
from repro.training import losses as jlosses  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import serve_step as tserve  # noqa: E402
from repro_torch.training import losses, train_step  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

MOE = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
RNG = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MIN_GAP = 1e-4


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(arch, **over):
    return (jget_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


#: the reference's moe_ffn, compiled once per (config, options, shape):
#: un-jitted, its scan and vmap bodies compile anew at every call
_jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=(0,), static_argnames=(
    "mode", "capacity_factor", "act", "per_row"))
_jmoe_decode = jax.jit(jmoe.moe_ffn_decode, static_argnums=(0,))


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference model, its params, port model, port params,
    the reference's jitted forward, prefill and decode_step)."""
    out = {}
    for arch in MOE:
        jcfg, tcfg = _cfgs(arch)
        jm, tm = jregistry.get_model(jcfg), registry.get_model(tcfg)
        jp = jm.init_params(RNG)
        tp = interop.params_from_repro(tcfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
        jfns = {"forward": jax.jit(jm.forward, static_argnames=("moe_mode",)),
                "prefill": jax.jit(jm.prefill, static_argnames=("moe_mode",)),
                "decode_step": jax.jit(jm.decode_step)}
        out[arch] = (jm, jp, tm, tp, jfns)
    return out


# ---------------------------------------------------------------------------
# The reference's routing and dispatch, step by step
# ---------------------------------------------------------------------------


def _ref_dispatch(jcfg, jp, tokens, capacity_factor):
    """``repro/models/moe.py:_moe_tokens``'s routing and dispatch over one
    group ``tokens`` [N, E], line by line: (probs, idx, the kept flag of
    each assignment, src with sentinel -1, C)."""
    N, _ = tokens.shape
    X, K = jcfg.num_experts, jcfg.num_experts_per_tok
    logits = jnp.einsum("ne,ex->nx", jnp.asarray(tokens, jnp.float32),
                        jp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    C = int(max(1, -(-N * K // X) * capacity_factor))
    flat_x = idx.reshape(-1)
    order = jnp.argsort(flat_x)
    sorted_x = flat_x[order]
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(jnp.bincount(flat_x, length=X)).astype(jnp.int32)[:-1]])
    rank = jnp.arange(N * K, dtype=jnp.int32) - starts[sorted_x]
    keep = rank < C
    slot = jnp.where(keep, sorted_x * C + rank, X * C)
    src = jnp.full((X * C,), N * K, jnp.int32).at[slot].set(order,
                                                           mode="drop")
    kept = np.zeros(N * K, bool)
    kept[np.asarray(order)] = np.asarray(keep)
    src = np.asarray(src).astype(np.int64)
    return (np.asarray(probs), np.asarray(idx), kept,
            np.where(src == N * K, -1, src), C)


def _min_gap(probs, K):
    s = -np.sort(-probs, axis=-1)
    return float((s[..., K - 1] - s[..., K]).min())


CASES = [(arch, per_row, cf) for arch in MOE for per_row in (True, False)
         for cf in (1.25, 0.5)]


@pytest.mark.parametrize("arch,per_row,cf", CASES)
def test_routing_and_dispatch_equal_the_reference(arch, per_row, cf):
    """Top-k ids, the kept/dropped set and every slot's assignment equal
    the reference's, per row (``per_row``) or over the whole batch; at
    ``cf`` = 0.5 assignments drop, and N·K/X is no integer (9·2/4)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg)
    x = _x(1, 3, 9, 64)
    X, K = tcfg.num_experts, tcfg.num_experts_per_tok
    rows = x if per_row else x.reshape(1, 27, 64)
    R, N, _ = rows.shape
    _, _, idx = tmoe._route(tp, _t(rows), K)
    C = tmoe.capacity(N, K, X, cf)
    plan = tmoe._dispatch_plan(idx, X, C)
    src = torch.where(plan.valid, plan.src, -1).reshape(X, R, C)
    kept = plan.kept.reshape(R, N * K).numpy()
    for r in range(R):
        probs, jidx, jkept, jsrc, jC = _ref_dispatch(jcfg, jp, rows[r], cf)
        assert C == jC
        assert _min_gap(probs, K) > MIN_GAP
        np.testing.assert_array_equal(idx[r].numpy(), jidx)
        np.testing.assert_array_equal(kept[r], jkept)
        got = src[:, r].numpy()
        got = np.where(got < 0, -1, got - r * N * K).reshape(-1)
        np.testing.assert_array_equal(got, jsrc)
    if cf < 1:
        assert not kept.all()


def test_capacity_is_the_reference_formula():
    assert tmoe.capacity(2048, 8, 128, 1.25) == 160
    assert tmoe.capacity(1024, 8, 128, 1.25) == 80
    assert tmoe.capacity(1, 8, 128, 2.0) == 2
    assert tmoe.capacity(1, 1, 16, 2.0) == 2
    assert tmoe.capacity(9, 2, 4, 0.5) == 2  # ceil(4.5) * 0.5
    assert tmoe.capacity(1, 1, 16, 0.1) == 1


def test_top_k_ties_go_to_the_lower_expert():
    """``jax.lax.top_k`` keeps the lower index among equal values; so does
    the port's stable descending sort."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 2)
    vals, order = torch.sort(_t(probs), dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(order[:, :2].numpy(), np.asarray(want))
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    router = torch.zeros((64, 4))  # equal logits: every expert ties
    _, _, idx = tmoe._route({"router": router}, torch.ones((3, 64)),
                            cfg.num_experts_per_tok)
    assert idx.tolist() == [[0, 1]] * 3


def _slot_inputs(seed):
    """A dispatch of 13 tokens, top-4 of 8 experts, with drops; slot
    values of mixed magnitude (so that the order of addition shows)."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced(num_experts=8,
                                                  num_experts_per_tok=4)
    rng = np.random.default_rng(seed)
    N, X, K = 13, 8, 4
    router = _t(rng.standard_normal((16, X)).astype(np.float32))
    _, _, idx = tmoe._route({"router": router},
                            _t(rng.standard_normal((N, 16)).astype(
                                np.float32)), K)
    C = tmoe.capacity(N, K, X, 0.75)
    plan = tmoe._dispatch_plan(idx[None], X, C)
    y = (rng.standard_normal((X * C, 16))
         * 10.0 ** rng.integers(-4, 5, (X * C, 16))).astype(np.float32)
    y[~plan.valid.numpy()] = 0.0
    # the reference's token of each slot: padding slots go to token N - 1
    src = torch.where(plan.valid, plan.src, N * K).numpy()
    ref_tok = np.minimum(src, N * K - 1) // K
    return cfg, plan, y, ref_tok, N


def test_combine_back_equals_the_reference_scatter_bit_for_bit():
    """The combiner's holder: ``jnp.zeros.at[src_tok].add`` over the slots
    (the reference's combine flow) and the port's ascending-slot sum give
    the same bits; another order of the same terms does not."""
    _, plan, y, ref_tok, N = _slot_inputs(2)
    want = np.asarray(jnp.zeros((N, 16), jnp.float32).at[ref_tok].add(
        jnp.asarray(y), mode="drop"))
    got = tmoe._sum_slots(_t(y), plan).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    rev = plan._replace(tok_slots=torch.flip(plan.tok_slots, [1]))
    assert not np.array_equal(tmoe._sum_slots(_t(y), rev).numpy(), want)
    assert int((plan.tok_slots < 0).sum()) > 0  # some assignments dropped


def test_dispatch_backward_equals_the_reference_bit_for_bit():
    """d tokens of the dispatch gather: JAX's transpose of
    ``tokens[src_tok]`` (a scatter-add) and :class:`_Dispatch`'s backward
    give the same bits."""
    _, plan, g, ref_tok, N = _slot_inputs(3)
    valid = plan.valid.numpy()
    toks = _x(4, N, 16)
    _, vjp = jax.vjp(lambda t: jnp.where(jnp.asarray(valid)[:, None],
                                         t[ref_tok], 0), jnp.asarray(toks))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = _t(toks).requires_grad_(True)
    (got,) = torch.autograd.grad(tmoe._Dispatch.apply(t, plan), t, _t(g))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("arch,per_row,cf", CASES)
@pytest.mark.parametrize("mode", ["combiner", "materialize"])
def test_moe_ffn_against_reference(arch, per_row, cf, mode):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg)
    x = _x(1, 3, 9, 64)
    jo, jaux = _jmoe_ffn(jcfg, jp, jnp.asarray(x), mode=mode,
                         capacity_factor=cf, per_row=per_row)
    to, taux = tmoe.moe_ffn(tcfg, tp, _t(x), mode=mode, capacity_factor=cf,
                            per_row=per_row)
    assert to.shape == (3, 9, 64) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=0,
                               atol=1e-6)


def test_moe_modes_agree_at_top4_of_8():
    """Combiner and materialize, K = 4 of X = 8 with drops, against the
    reference and each other."""
    over = dict(num_experts=8, num_experts_per_tok=4)
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", **over)
    jp, tp = _moe_params(jcfg, seed=1)
    x = _x(5, 2, 11, 64)
    outs = {}
    for mode in ("combiner", "materialize"):
        jo, _ = _jmoe_ffn(jcfg, jp, jnp.asarray(x), mode=mode,
                          capacity_factor=0.75)
        outs[mode], _ = tmoe.moe_ffn(tcfg, tp, _t(x), mode=mode,
                                     capacity_factor=0.75)
        np.testing.assert_allclose(outs[mode].numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(outs["combiner"].numpy(),
                               outs["materialize"].numpy(), **TOL)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mode", ["combiner", "materialize"])
def test_moe_ffn_gradients_against_jax_grad(arch, mode):
    """d/d(x, router, w_gate, w_up, w_down) of ``Σ out · w + 0.1 · lb``,
    with drops (capacity factor 0.5), per row."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg)
    x, w = _x(6, 2, 9, 64), _x(7, 2, 9, 64)

    def jloss(x, p):
        out, aux = jmoe.moe_ffn(jcfg, p, x, mode=mode, capacity_factor=0.5)
        return jnp.sum(out * w) + 0.1 * aux["load_balance_loss"]

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jp)
    tx = _t(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out, aux = tmoe.moe_ffn(tcfg, leaves, tx, mode=mode, capacity_factor=0.5)
    loss = torch.sum(out * _t(w)) + 0.1 * aux["load_balance_loss"]
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [tx] + [leaves[k] for k in names])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **GRAD_TOL)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]),
                                   **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_decode_against_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg)
    for b in (1, 5):
        x = _x(8 + b, b, 1, 64)
        want = _jmoe_decode(jcfg, jp, jnp.asarray(x))
        got = tmoe.moe_ffn_decode(tcfg, tp, _t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            got.numpy(), tmoe.moe_ffn(tcfg, tp, _t(x), capacity_factor=2.0)[
                0].numpy(), rtol=0, atol=0)


class _Recorder(TorchDispatchMode):
    """Records every aten call; for the accumulating scatters, whether an
    index value repeats (along the scattered dimension)."""

    ACCUMULATING = ("index_add", "index_add_", "scatter_add", "scatter_add_",
                    "scatter_reduce", "scatter_reduce_")

    def __init__(self):
        super().__init__()
        self.names, self.repeats = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.names.append(name)
        if name in self.ACCUMULATING:
            dim, index = args[1], args[2]
            s = torch.sort(index.reshape(-1) if index.dim() == 1
                           else index.movedim(dim, -1), dim=-1).values
            if bool((s[..., 1:] == s[..., :-1]).any()):
                self.repeats.append(name)
        elif name in ("index_put", "index_put_") and (
                args[3] if len(args) > 3 else kwargs.get("accumulate")):
            idx = torch.stack(torch.broadcast_tensors(
                *[i for i in args[1] if i is not None]), -1).reshape(
                -1, len([i for i in args[1] if i is not None]))
            if torch.unique(idx, dim=0).shape[0] < idx.shape[0]:
                self.repeats.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("mode", ["combiner", "materialize"])
def test_no_accumulating_scatter_over_repeated_indices(mode):
    """The determinism guard: in ``moe_ffn``'s forward and backward (with
    drops and padding slots, per row and globally), no ``index_add``,
    ``scatter_add``, ``scatter_reduce`` or accumulating ``index_put`` runs
    over an index with a repeated value (the calls that take float atomics
    on CUDA)."""
    _, tcfg = _cfgs("qwen3-moe-30b-a3b", num_experts=8,
                    num_experts_per_tok=4)
    jcfg = jget_config("qwen3-moe-30b-a3b").reduced(num_experts=8,
                                                    num_experts_per_tok=4)
    _, tp = _moe_params(jcfg)
    for per_row in (True, False):
        x = _t(_x(9, 3, 10, 64)).requires_grad_(True)
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        with _Recorder() as rec:
            out, aux = tmoe.moe_ffn(tcfg, leaves, x, mode=mode,
                                    capacity_factor=0.5, per_row=per_row)
            loss = out.square().sum() + aux["load_balance_loss"]
            torch.autograd.grad(loss, [x, *leaves.values()])
        assert not rec.repeats, rec.repeats
        assert {"sort", "bmm", "index"} <= set(rec.names)


# ---------------------------------------------------------------------------
# The model: forward, serving, loss, training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_configs_and_parameters_are_the_reference(arch):
    j, t = jget_config(arch), get_config(arch)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    # a bf16 model at reduced size: the reference's tree (its shapes, by
    # eval_shape), the router f32
    jcfg, tcfg = (j.reduced(dtype=jnp.bfloat16),
                  t.reduced(dtype=torch.bfloat16))
    jp = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                      jregistry.get_model(jcfg).abstract_params())
    tp = registry.get_model(tcfg).init_params(
        torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree.flatten_with_path(jp)[0]}
    got = {jax.tree_util.keystr(p): (tuple(x.shape),
                                     str(x.dtype).replace("torch.", ""))
           for p, x in jax.tree.flatten_with_path(tp)[0]}
    assert got == want
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    carried = interop.params_from_repro(tcfg, jp, device="cpu")
    assert carried["layers"]["moe"]["router"].dtype == torch.float32
    assert carried["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    assert (registry.active_param_count(tcfg, carried)
            == jregistry.active_param_count(jcfg, jp))
    assert (registry.param_count(carried) == jregistry.param_count(jp))
    with pytest.raises(ValueError, match="'moe'"):
        interop.params_from_repro(
            get_config("llama3-8b").reduced(dtype=torch.bfloat16), jp,
            device="cpu")


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_logits(models, arch):
    jm, jp, tm, tp, jfns = models[arch]
    toks = np.random.default_rng(10).integers(
        0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    for mode in ("combiner", "materialize"):
        jh, jaux = jfns["forward"](jp, {"tokens": jnp.asarray(toks)},
                                   moe_mode=mode)
        th, taux = tm.forward(tp, {"tokens": _t(toks)}, moe_mode=mode)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(float(taux["load_balance_loss"]),
                                   float(jaux["load_balance_loss"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            tm.logits_of_hidden(tp, th).numpy(),
            np.asarray(jm.logits_of_hidden(jp, jh)), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_logits(models, arch):
    """prefill (both MoE modes) and five decode steps (kernel route and
    plain) against the reference's."""
    jm, jp, tm, tp, jfns = models[arch]
    prompt = np.random.default_rng(11).integers(
        0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    for mode, use_kernels in (("combiner", True), ("materialize", False)):
        jst = jm.init_decode_state(2, 24)
        tst = tm.init_decode_state(2, 24, device="cpu")
        jl, jst = jfns["prefill"](jp, {"tokens": jnp.asarray(prompt)}, jst,
                                  moe_mode=mode)
        tl, tst = tm.prefill(tp, {"tokens": _t(prompt)}, tst, moe_mode=mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        for _ in range(5):
            jl, jst = jfns["decode_step"](jp, jst, jnp.asarray(tok))
            tl, tst = tm.decode_step(tp, tst, _t(tok),
                                     use_kernels=use_kernels)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert tst["pos"] == int(jst["pos"]) == 17


def test_generate_greedy_tokens_equal_the_reference(models):
    jm, jp, tm, tp, _ = models["qwen3-moe-30b-a3b"]
    prompt = np.random.default_rng(12).integers(
        0, tm.cfg.vocab_size, (3, 9)).astype(np.int32)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompt),
                                      max_new=6))
    got = tserve.generate(tm, tp, _t(prompt), max_new=6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_matches_stepwise(arch):
    """The reference's test_prefill_consistency property with its MoE
    tolerance (0.15: capacity dispatch over the prompt drops where
    per-token routing does not), on the port's own parameters."""
    tm = registry.get_model(get_config(arch).reduced())
    params = tm.init_params(torch.Generator().manual_seed(0))
    prompt = torch.randint(0, tm.cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(3))
    st = tm.init_decode_state(2, 32, device="cpu")
    lg_a, st = tm.prefill(params, {"tokens": prompt}, st)
    tok = torch.argmax(lg_a, -1).to(torch.int32)
    lg_a2, _ = tm.decode_step(params, st, tok)
    st_b = tm.init_decode_state(2, 32, device="cpu")
    for t in range(prompt.shape[1]):
        lg_b, st_b = tm.decode_step(params, st_b, prompt[:, t])
    lg_b2, _ = tm.decode_step(params, st_b, tok)
    err1 = (torch.softmax(lg_a, -1) - torch.softmax(lg_b, -1)).abs().max()
    err2 = (torch.softmax(lg_a2, -1) - torch.softmax(lg_b2, -1)).abs().max()
    assert float(err1) < 0.15 and float(err2) < 0.15


@pytest.mark.parametrize("arch", MOE)
def test_lm_loss_in_both_moe_modes(models, arch):
    jm, jp, tm, tp, _ = models[arch]
    rng = np.random.default_rng(13)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    labels[1, :4] = -1
    got = {}
    for mode in ("combiner", "materialize"):
        jl, jaux = jlosses.lm_loss(jm, jp, {"tokens": toks, "labels": labels},
                                   moe_mode=mode, vocab_chunk=48)
        tl, taux = losses.lm_loss(tm, tp, {"tokens": _t(toks),
                                           "labels": _t(labels)},
                                  moe_mode=mode, vocab_chunk=48)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(taux["load_balance_loss"]),
                                   float(jaux["load_balance_loss"]),
                                   rtol=0, atol=1e-6)
        assert set(taux) == set(jaux) == {"xent", "load_balance_loss"}
        assert float(taux["load_balance_loss"]) > 0
        got[mode] = float(tl)
    np.testing.assert_allclose(got["combiner"], got["materialize"],
                               rtol=1e-5)


#: (arch, moe_mode): three train steps each
STEP_CASES = [("qwen3-moe-30b-a3b", "combiner"),
              ("llama4-scout-17b-a16e", "materialize")]


def _tc(mode):
    return dict(num_microbatches=2, vocab_chunk=48, warmup_steps=1,
                total_steps=50, moe_mode=mode)


@pytest.mark.parametrize("arch,mode", STEP_CASES)
def test_train_steps_against_reference(arch, mode):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jregistry.get_model(jcfg), registry.get_model(tcfg)
    jstep = jax.jit(jtrain.make_train_step(
        jm, jtrain.TrainConfig(**_tc(mode))))
    jstate = jtrain.init_train_state(jm, RNG)
    state = interop.train_state_from_repro(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    step = train_step.make_train_step(tm, train_step.TrainConfig(
        **_tc(mode)))
    dc = pipeline.DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                             global_batch=4)
    for i in range(3):
        b = pipeline.global_batch(dc, i)
        jstate, jm_ = jstep(jstate, b)
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["load_balance_loss"]),
                                   float(jm_["load_balance_loss"]),
                                   rtol=1e-4)
        for a, w in zip(flatten(state["master"])[0],
                        jax.tree.leaves(jstate["master"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)


def test_serve_cli_on_the_cpu(capsys):
    tlaunch.main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device",
                  "cpu", "--batch", "2", "--prompt-len", "5", "--max-new",
                  "4"])
    out = capsys.readouterr().out
    assert "qwen3-moe-30b-a3b" in out and "tokens/s" in out


def test_bf16_modes_agree_within_the_stated_tolerances():
    """In bf16 the combiner adds a token's K outputs in bf16 and
    materialize sums them in f32 and rounds once.  At top-8 of 16 experts
    (reduced width): on one input the two modes' outputs within 2^-5 of
    the output's rms and max (the serve gate, which ``chip_smoke.py``
    phase 15 holds them to at full width), and the loss of both within
    rtol 1e-3 (phase 15's ``MOE_LOSS_RTOL``).  At top-2 both sum two bf16
    terms and round once: equal bits."""
    for over, equal in ((dict(num_experts=16, num_experts_per_tok=8,
                              d_ff=48), False), ({}, True)):
        cfg = get_config("qwen3-moe-30b-a3b").reduced(dtype=torch.bfloat16,
                                                      **over)
        model = registry.get_model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0))
        layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
        h = torch.randn((4, 64, 64), generator=torch.Generator().manual_seed(
            2)).to(torch.bfloat16)
        out = {m: tmoe.moe_ffn(cfg, layer, h, mode=m)[0].float()
               for m in ("combiner", "materialize")}
        diff = out["combiner"] - out["materialize"]
        ref = out["materialize"]
        rms = float(diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
        mx = float(diff.abs().max() / ref.abs().max())
        assert (rms == mx == 0) if equal else (0 < rms <= 2 ** -5
                                               and mx <= 2 ** -5)
        batch = {k: _t(v) for k, v in pipeline.global_batch(
            pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                global_batch=4), 0).items()}
        with torch.no_grad():
            lc, lm = (float(losses.lm_loss(model, params, batch, moe_mode=m,
                                           vocab_chunk=64)[0])
                      for m in ("combiner", "materialize"))
        assert abs(lc - lm) <= 1e-3 * abs(lm)
