"""``--o adam`` and ``--bf16_momentum`` in the port
(``tllod_torch/utils/optim.py``) against the JAX package's optax chains
(``tllod_tpu/utils/optim.py::make_adam``, ``make_sgd(momentum_dtype=
bfloat16)``): the same gradients, drawn with numpy, go through both over
4 updates that cross an epoch boundary of the schedule (lr × 0.1 from the
third). The parameters include a frozen one (``backbone/conv1_1``), a
weight and a bias of each trained kind (the bias at twice the rate, no
decay), and a trainable parameter that gets no gradient
(``backbone_anc/conv1_1``: JAX's mask keeps it, so decay moves it). The
clip is on, at a norm the gradients pass, so it scales them.

Tolerances: Adam's parameters within 4 float32 spacings of JAX's (its
bias corrections are powers taken in float32 by XLA and by numpy, which
may part by an ulp), its moments within 1e-6 relative plus 1e-6 of each
tensor's largest entry (the clip's global norm sums in another order, and
a moment that cancels keeps that ulp); the bf16-momentum
SGD's stored trace bit-equal (bfloat16) and its parameters within 2
float32 spacings. Then both through ``train.TrainStepMulti``'s CPU path
against eager steps (bit-equal on one CPU thread) and through
``state_dict`` round trips."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tllod_tpu.utils import optim as jopt
from tllod_torch.train import TrainStepMulti, train_step
from tllod_torch.utils.optim import SGD, Adam, epoch_decay_schedule

SHAPES = {"backbone/conv1_1/kernel": (3, 4),
          "backbone/conv3_1/kernel": (5, 6),
          "backbone/conv3_1/bias": (6,),
          "head/fc6/kernel": (7, 3),
          "head/fc6/bias": (3,),
          "backbone_anc/conv1_1/kernel": (4, 4)}
NO_GRAD = "backbone_anc/conv1_1/kernel"
LR, STEPS_PER_EPOCH, DECAY_STEP = 0.01, 2, 1     # lr x 0.1 from update 2
CLIP = 10.0


def _port_name(path):
    return path.replace("/", ".").replace("kernel", "weight")


def _tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _run(kind, n_updates=4, seed=0):
    """The same updates through optax and the port; returns (JAX params,
    port params, optax state, port optimizer)."""
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 2).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(n_updates)]
    schedule = jopt.epoch_decay_schedule(LR, STEPS_PER_EPOCH, DECAY_STEP)
    if kind == "adam":
        tx = jopt.make_adam(schedule, clip_norm=CLIP)
    else:
        tx = jopt.make_sgd(schedule, clip_norm=CLIP,
                           momentum_dtype=jnp.bfloat16)
    jp = _tree(params)
    state = tx.init(jp)
    tp = {_port_name(k): torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    sched = epoch_decay_schedule(LR, STEPS_PER_EPOCH, DECAY_STEP)
    opt = (Adam(tp.items(), sched, clip_norm=CLIP) if kind == "adam" else
           SGD(tp.items(), sched, clip_norm=CLIP,
               momentum_dtype=torch.bfloat16))
    for g in grads:
        g = dict(g, **{NO_GRAD: np.zeros(SHAPES[NO_GRAD], np.float32)})
        updates, state = tx.update(_tree(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = (None if k == _port_name(NO_GRAD) else
                      torch.from_numpy(g[k.replace(".", "/").replace(
                          "weight", "kernel")].copy()))
        opt.step()
    return (_flat(jp), {k: p.detach().numpy() for k, p in tp.items()},
            state, opt, params)


def _within_spacings(got, want, n):
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return bool((err <= n * np.spacing(np.abs(want))).all()), err.max()


def test_adam_matches_optax_make_adam():
    """Mask, clip, decay on trainable non-biases, ``scale_by_adam`` (eps
    outside the root, bias corrections of the update's 1-based count), ×
    −lr, × 2 on biases, mask: four updates across the epoch boundary."""
    jp, tp, state, opt, init = _run("adam")
    for path, want in jp.items():
        ok, err = _within_spacings(tp[_port_name(path)], want, 4)
        assert ok, (path, err)
    assert np.array_equal(tp["backbone.conv1_1.weight"],
                          init["backbone/conv1_1/kernel"])
    (adam_state,) = [s for s in state if isinstance(s, optax.ScaleByAdamState)]
    assert int(adam_state.count) == opt.count == 4
    sd = opt.state_dict()
    for key in ("mu", "nu"):
        want = _flat(getattr(adam_state, key))
        for path, w in want.items():
            if path.startswith("backbone/conv1_1"):
                continue                       # frozen: not in the port's
            got = sd[key][_port_name(path)].numpy()
            np.testing.assert_allclose(got, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{key} {path}")


def test_adam_moves_a_trainable_zero_gradient_parameter_by_about_lr():
    """``backbone_anc/conv1_1`` gets no gradient but is trainable (JAX's
    mask): its gradient is the decay alone, which Adam normalises, so each
    update moves every entry by about lr (0.01, then 0.001), as optax
    moves it."""
    jp, tp, _, _, init = _run("adam")
    name = _port_name(NO_GRAD)
    moved = np.abs(tp[name] - init[NO_GRAD])
    # two updates at lr, two at lr / 10, each ~lr·|m̂/√n̂| with |·| ≈ 1
    lo, hi = 0.8 * 2.2 * LR, 1.2 * 2.2 * LR
    assert ((moved > lo) & (moved < hi)).all(), (moved.min(), moved.max())
    ok, err = _within_spacings(tp[name], jp[NO_GRAD], 4)
    assert ok, err


def test_bf16_momentum_sgd_matches_optax_trace():
    """optax 0.2.6's ``trace`` with ``accumulator_dtype=bfloat16``: v = g +
    μ·t (μ and the product in bfloat16, promoted by the float32 g), the
    update uses v unrounded and the trace stores v in bfloat16. The stored
    trace is bit-equal and the parameters within 2 float32 spacings."""
    jp, tp, state, opt, _ = _run("sgd_bf16")
    for path, want in jp.items():
        ok, err = _within_spacings(tp[_port_name(path)], want, 2)
        assert ok, (path, err)
    (trace_state,) = [s for s in state if isinstance(s, optax.TraceState)]
    traces = opt.state_dict()["trace"]
    for path, want in _flat(trace_state.trace).items():
        if path.startswith("backbone/conv1_1"):
            continue
        got = traces[_port_name(path)]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32),
                                      err_msg=path)


class _Quadratic(torch.nn.Module):
    """A tiny model with the train step's calling convention: a loss from
    a weight, a bias and a trainable parameter that gets no gradient."""

    device = torch.device("cpu")

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.backbone_anc = torch.nn.Linear(3, 3)
        self.fc = torch.nn.Linear(3, 2)
        for p in self.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x, *, training=True, rng=None):
        noise = rng.uniform(x.shape)
        y = self.fc(x * noise)
        return {"loss_sq": (y ** 2).sum()}


def _optimizer(kind, model):
    sched = epoch_decay_schedule(LR, STEPS_PER_EPOCH, DECAY_STEP)
    if kind == "adam":
        return Adam(model.named_parameters(), sched, clip_norm=CLIP)
    return SGD(model.named_parameters(), sched,
               momentum_dtype=torch.bfloat16, clip_norm=CLIP)


@pytest.mark.parametrize("kind", ["adam", "sgd_bf16"])
def test_fused_trainer_cpu_path_equals_eager_steps(kind):
    """``TrainStepMulti`` on the CPU (its plain path) takes the eager
    steps' trajectory under Adam and the bfloat16 trace: parameters and
    optimizer state bit-equal after 4 steps in one call."""
    batches = [(torch.full((4, 3), float(i + 1)),) for i in range(4)]
    runs = []
    for fused in (False, True):
        model = _Quadratic()
        opt = _optimizer(kind, model)
        loss = lambda out: out["loss_sq"]            # noqa: E731
        if fused:
            TrainStepMulti(model, loss, opt, seed=5)(0, batches)
        else:
            for i, args in enumerate(batches):
                train_step(model, loss, opt, args, seed=5, step=i)
        runs.append((model.state_dict(), opt.state_dict()))
    (pa, sa), (pb, sb) = runs
    assert sa["count"] == sb["count"] == 4
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for key in sa:
        if key != "count":
            for n in sa[key]:
                assert torch.equal(sa[key][n], sb[key][n]), (key, n)


@pytest.mark.parametrize("kind", ["adam", "sgd_bf16"])
def test_state_dict_round_trip_resumes_the_trajectory(kind):
    """Two steps, the optimizer's ``state_dict`` saved and loaded into a
    new optimizer over a copy of the model, then two more steps on each:
    the same parameters and state, the trace still bfloat16."""
    model = _Quadratic()
    opt = _optimizer(kind, model)
    loss = lambda out: out["loss_sq"]                # noqa: E731
    x = (torch.ones(4, 3),)
    for i in range(2):
        train_step(model, loss, opt, x, seed=1, step=i)
    saved = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v)
             for k, v in opt.state_dict().items()}
    twin = _Quadratic()
    twin.load_state_dict(model.state_dict())
    twin_opt = _optimizer(kind, twin)
    twin_opt.load_state_dict(saved)
    for m, o in ((model, opt), (twin, twin_opt)):
        for i in range(2, 4):
            train_step(m, loss, o, x, seed=1, step=i)
    for k, v in model.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    a, b = opt.state_dict(), twin_opt.state_dict()
    assert a["count"] == b["count"] == 4
    for key in a:
        if key != "count":
            for n, t in a[key].items():
                assert t.dtype == b[key][n].dtype
                assert torch.equal(t, b[key][n]), (key, n)
    if kind == "sgd_bf16":
        assert all(t.dtype == torch.bfloat16 for t in a["trace"].values())
    with pytest.raises(KeyError):
        _optimizer("sgd_bf16" if kind == "adam" else "adam",
                   twin).load_state_dict(saved)
