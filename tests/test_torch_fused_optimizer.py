"""The fused multi-tensor optimizer (``paddle_tpu_torch/optimizer/fused.py``
over ``kernels/fused_optimizer.py``) against the port's per-parameter
path and the reference's fused path (``paddle_tpu/optimizer/fused.py``),
mirroring ``tests/test_train_fastpath.py``'s ``TestFusedEagerParity``;
the ``need_clip`` semantics of both clip paths against the reference;
``TrainStep`` on the fused path (anomaly guard included) against
``TrainStep`` on the per-parameter path.

Tolerances: on the CPU the fused path runs the per-parameter ops tensor
by tensor, so it equals that path bit for bit; against the reference
(XLA on the CPU, which may fuse ops into FMAs) rtol 1e-6, atol 1e-7, the
reference's own fused-vs-per-param tolerance. The ``cuda`` cases hold
the kernels to their plain versions on the card (tolerances below) and
skip without one; they import nothing of JAX, so the card runs them with
``python -m pytest --noconftest -m cuda tests/test_torch_fused_optimizer.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.framework.flags import set_flags as port_set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import fused_optimizer as fk
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW, Momentum
from paddle_tpu_torch.optimizer.fused import dispatch_counts, fused_plan
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

REF_TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = ((4, 3), (7,), (2, 2, 2), (5, 5))


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    port_set_flags({"fused_optimizer": True})


@pytest.fixture()
def ref():
    """The reference package, its fused_optimizer flag on (and restored)."""
    import paddle_tpu
    paddle_tpu.set_flags({"fused_optimizer": True})
    yield paddle_tpu
    paddle_tpu.set_flags({"fused_optimizer": True})


def _init(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _grad(shape, step, i, scale=1.0):
    return np.random.RandomState(100 * step + i).randn(*shape) \
        .astype(np.float32) * scale


def _params(shapes=SHAPES, dtype=torch.float32, device="cpu"):
    return [torch.nn.Parameter(torch.from_numpy(a).to(device, dtype))
            for a in _init(shapes)]


def _set_grads(ps, step, scale=1.0):
    for i, p in enumerate(ps):
        p.grad = torch.from_numpy(_grad(tuple(p.shape), step, i, scale)) \
            .to(p.device, p.dtype)


def _bitwise(a, b):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


CASES = {
    "sgd": (SGD, {"weight_decay": 0.01}),
    "momentum_nesterov": (Momentum, {"use_nesterov": True,
                                     "weight_decay": 0.02}),
    "adam": (Adam, {"weight_decay": 0.01}),
    "adamw": (AdamW, {"weight_decay": 0.05}),
}
REF_OPTIMIZERS = {"sgd": "SGD", "momentum_nesterov": "Momentum",
                  "adam": "Adam", "adamw": "AdamW"}


def _ref_params(ref, shapes=SHAPES):
    import jax.numpy as jnp
    from paddle_tpu.tensor import Parameter
    return [Parameter(jnp.asarray(a)) for a in _init(shapes)]


def _ref_set_grads(ref, ps, step, scale=1.0):
    for i, p in enumerate(ps):
        p.grad = ref.to_tensor(_grad(tuple(p._value.shape), step, i, scale))


def _run_port(case, fused, steps=3, dtype=torch.float32, scale=1.0,
              prepare=None, **extra):
    port_set_flags({"fused_optimizer": fused})
    cls, kw = CASES[case]
    ps = _params(dtype=dtype)
    if prepare is not None:
        prepare(ps)
    opt = cls(learning_rate=0.05, parameters=ps, **kw, **extra)
    for s in range(steps):
        _set_grads(ps, s, scale)
        opt.step()
    return ps, opt


# ------------------------------------------------------ eager parity --

@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_per_param(case):
    """Three steps on the fused path equal three on the per-parameter
    path bit for bit: parameters and every state tensor."""
    pf, of = _run_port(case, True)
    pp, op = _run_port(case, False)
    _bitwise(pf, pp)
    assert of._fused_plan is not None and of._fused_plan.n_calls == 3
    for a, b in zip(pf, pp):
        sa, sb = of._state_of(a), op._state_of(b)
        assert set(sa) == set(sb)
        _bitwise([sa[k] for k in sorted(sa)], [sb[k] for k in sorted(sb)])


@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_reference_fused(ref, case):
    """The port's fused path against the reference's fused path (both
    with the flag on), three steps from the same numpy inputs."""
    rps = _ref_params(ref)
    ropt = getattr(ref.optimizer, REF_OPTIMIZERS[case])(
        learning_rate=0.05, parameters=rps, **CASES[case][1])
    for s in range(3):
        _ref_set_grads(ref, rps, s)
        ropt.step()
    assert ropt._fused_plan is not None
    ps, _ = _run_port(case, True)
    for p, r in zip(ps, rps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r._value),
                                   **REF_TOL)


def test_adamw_decay_fun_and_clip():
    """apply_decay_param_fun sees the eager path's param<i> names; the
    global-norm clip runs inside the fused step."""
    kw = dict(apply_decay_param_fun=lambda n: n in ("param0", "param2"),
              grad_clip=ClipGradByGlobalNorm(0.5))
    pf, of = _run_port("adamw", True, scale=3.0, **kw)
    pp, _ = _run_port("adamw", False, scale=3.0, **kw)
    assert of._fused_plan is not None
    assert of._fused_plan.table.coeffs["wd"] == [0.05, 0.0, 0.05, 0.0]
    _bitwise(pf, pp)


@pytest.mark.parametrize("clip", [ClipGradByNorm(0.7), ClipGradByValue(0.4)],
                         ids=["norm", "value"])
def test_per_tensor_clips_fuse(clip):
    pf, of = _run_port("momentum_nesterov", True, scale=2.0, grad_clip=clip)
    pp, _ = _run_port("momentum_nesterov", False, scale=2.0, grad_clip=clip)
    assert of._fused_plan is not None
    _bitwise(pf, pp)


@pytest.mark.parametrize("clip", [None, ClipGradByGlobalNorm(2.0)],
                         ids=["no_clip", "global_norm"])
def test_multi_precision_master_weights(clip):
    """bf16 parameters with f32 master weights: masters, moments and the
    bf16 parameters equal the per-parameter path's; the global-norm clip
    applies in the gradient's dtype (bf16)."""
    pf, of = _run_port("adamw", True, dtype=torch.bfloat16, grad_clip=clip)
    pp, op = _run_port("adamw", False, dtype=torch.bfloat16, grad_clip=clip)
    _bitwise(pf, pp)
    for a, b in zip(pf, pp):
        sa, sb = of._state_of(a), op._state_of(b)
        assert sa["master_weight"].dtype == torch.float32
        _bitwise([sa[k] for k in sorted(sa)], [sb[k] for k in sorted(sb)])


@pytest.mark.parametrize("mp", [True, False], ids=["masters", "no_masters"])
@pytest.mark.parametrize("case", ["momentum_nesterov", "adamw"])
def test_float16_fused_matches_per_param(case, mp):
    """f16 parameters, with f32 master weights or without: the fused path
    equals the per-parameter path, parameters and state, under a
    global-norm clip."""
    clip = ClipGradByGlobalNorm(2.0)
    pf, of = _run_port(case, True, dtype=torch.float16, grad_clip=clip,
                       multi_precision=mp)
    pp, op = _run_port(case, False, dtype=torch.float16, grad_clip=clip,
                       multi_precision=mp)
    assert of._fused_plan is not None
    assert [p.dtype for p in pf] == [torch.float16] * len(SHAPES)
    _bitwise(pf, pp)
    for a, b in zip(pf, pp):
        sa, sb = of._state_of(a), op._state_of(b)
        assert ("master_weight" in sa) == mp
        _bitwise([sa[k] for k in sorted(sa)], [sb[k] for k in sorted(sb)])


def test_mixed_dtype_buckets():
    """f32 and bf16 parameters (one with masters, one without) in one
    optimizer: one fused dispatch covers them all, equal to the
    per-parameter path."""
    def prepare(ps):
        ps[1].data = ps[1].data.to(torch.bfloat16)
        ps[3].data = ps[3].data.to(torch.bfloat16)

    def run(fused, mp):
        before = dict(dispatch_counts)
        ps, opt = _run_port("adam", fused, prepare=prepare, steps=2,
                            multi_precision=mp)
        return ps, opt, {k: dispatch_counts[k] - before[k] for k in before}
    for mp in (True, False):
        pf, of, df = run(True, mp)
        pp, _, dp = run(False, mp)
        assert df == {"fused": 2, "per_param": 0}
        assert dp == {"fused": 0, "per_param": 2 * len(SHAPES)}
        assert [p.dtype for p in pf] == [torch.float32, torch.bfloat16] * 2
        _bitwise(pf, pp)


def test_regularizers_fuse():
    """L1Decay / L2Decay (the optimizer's, or a parameter's own, which
    wins) are elementwise coefficients: the plan takes them."""
    def prepare(ps):
        ps[0].regularizer = L1Decay(0.03)
        ps[2].regularizer = L2Decay(0.2)
    for case, extra in (("momentum_nesterov", {}), ("adamw", {}),
                        ("sgd", {"weight_decay": L1Decay(0.01)})):
        kw = dict(CASES[case][1], **extra)
        runs = []
        for fused in (True, False):
            port_set_flags({"fused_optimizer": fused})
            ps = _params()
            prepare(ps)
            opt = CASES[case][0](learning_rate=0.05, parameters=ps, **kw)
            for s in range(3):
                _set_grads(ps, s)
                opt.step()
            runs.append((ps, opt))
        assert runs[0][1]._fused_plan is not None, case
        _bitwise(runs[0][0], runs[1][0])
    with pytest.raises(TypeError):
        AdamW(parameters=_params(), weight_decay=L2Decay(0.1))


def test_state_dict_roundtrip_and_path_switch():
    """state_dict keys stay per-parameter; a fresh optimizer restored
    from them continues on the per-parameter path exactly as the fused
    one continues on the fused path; then the first switches back."""
    ps, opt = _run_port("adam", True, steps=2)
    sd = opt.state_dict()
    assert set(sd) == {f"param{i}_{k}" for i in range(len(SHAPES))
                       for k in ("moment1", "moment2", "step")}
    ps2 = _params()
    with torch.no_grad():
        for p2, p in zip(ps2, ps):
            p2.copy_(p)
    opt2 = Adam(0.05, parameters=ps2, **CASES["adam"][1])
    opt2.set_state_dict(sd)
    port_set_flags({"fused_optimizer": False})
    _set_grads(ps2, 2)
    opt2.step()
    port_set_flags({"fused_optimizer": True})
    _set_grads(ps, 2)
    opt.step()
    _bitwise(ps, ps2)
    _set_grads(ps2, 3)
    opt2.step()                 # back on the fused path, after per-param
    _set_grads(ps, 3)
    opt.step()
    assert opt2._fused_plan is not None
    _bitwise(ps, ps2)
    assert all(int(opt2._state_of(p)["step"]) == 4 for p in ps2)


# ---------------------------------------------------------- fallbacks --

def _no_plan(opt):
    return getattr(opt, "_fused_plan", None) is None


def test_fallback_for_custom_regularizer():
    """A callable per-parameter regularizer is not elementwise: the step
    takes the per-parameter path, with the same result as the flag off."""
    def prepare(ps):
        ps[0].regularizer = lambda p, g: g + 0.1 * p * p
    pf, of = _run_port("sgd", True, prepare=prepare)
    pp, _ = _run_port("sgd", False, prepare=prepare)
    assert _no_plan(of)
    _bitwise(pf, pp)


def test_fallback_for_need_clip_with_a_clip(ref):
    """A clip and one parameter with need_clip=False: per-parameter path,
    equal to the reference's eager step (whose fused plan falls back
    too); without a clip the flag does not matter and the plan runs."""
    def prepare(ps):
        ps[1].need_clip = False
    clip = dict(grad_clip=ClipGradByGlobalNorm(0.5))
    pf, of = _run_port("adam", True, scale=3.0, prepare=prepare, **clip)
    assert _no_plan(of)
    rps = _ref_params(ref)
    rps[1].need_clip = False
    ropt = ref.optimizer.Adam(
        learning_rate=0.05, parameters=rps, weight_decay=0.01,
        grad_clip=ref.nn.ClipGradByGlobalNorm(0.5))
    for s in range(3):
        _ref_set_grads(ref, rps, s, 3.0)
        ropt.step()
    assert getattr(ropt, "_fused_plan", None) is None
    for p, r in zip(pf, rps):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r._value),
                                   **REF_TOL)
    _, of = _run_port("adam", True, prepare=prepare)
    assert of._fused_plan is not None


def test_fallback_for_disagreeing_steps():
    ps, opt = _run_port("adamw", True, steps=1)
    opt._state_of(ps[2])["step"].fill_(7)
    opt._state_gen += 1            # as a partial restore would
    _set_grads(ps, 1)
    opt.step()
    assert _no_plan(opt)
    assert [int(opt._state_of(p)["step"]) for p in ps] == [2, 2, 8, 2]


def test_fallback_for_other_types_and_raising_lr_ratio():
    class MyAdam(Adam):
        pass
    ps = _params()
    opt = MyAdam(0.05, parameters=ps)
    _set_grads(ps, 0)
    opt.step()
    assert _no_plan(opt)

    def ratio(p):
        raise RuntimeError("no ratio")
    opt = AdamW(0.05, parameters=ps, lr_ratio=ratio)
    _set_grads(ps, 0)
    with pytest.raises(RuntimeError, match="no ratio"):
        opt.step()                 # the per-parameter path calls it again
    assert _no_plan(opt)
    opt = AdamW(0.05, parameters=ps, lr_ratio=lambda p: 0.5)
    opt.step()
    assert opt._fused_plan.table.coeffs["lr_scale"] == [0.5] * 4


def test_one_dispatch_per_step():
    before = dict(dispatch_counts)
    ps, opt = _run_port("adam", True, steps=4)
    assert dispatch_counts["fused"] - before["fused"] == 4
    assert dispatch_counts["per_param"] == before["per_param"]
    plan = opt._fused_plan
    port_set_flags({"fused_optimizer": False})
    _set_grads(ps, 9)
    opt.step()
    assert dispatch_counts["per_param"] - before["per_param"] == len(ps)
    assert _no_plan(opt)           # retired on the way back
    port_set_flags({"fused_optimizer": True})
    opt.step()
    assert opt._fused_plan is not plan      # rebuilt: state was replaced


# ---------------------------------------------------------- need_clip --

@pytest.mark.parametrize("kind", ["global", "norm", "value"])
def test_need_clip_matches_reference_on_both_paths(ref, kind):
    """Eager: a parameter with need_clip=False keeps its gradient and
    stays out of the global norm (reference ``nn/clip.py``). TrainStep's
    ``clip_grads`` clips every gradient (reference
    ``_clip_grads_functional``)."""
    import jax.numpy as jnp
    from paddle_tpu.jit.bridge import _clip_grads_functional
    ref_cls, port_cls, arg = {
        "global": (ref.nn.ClipGradByGlobalNorm, ClipGradByGlobalNorm, 1.0),
        "norm": (ref.nn.ClipGradByNorm, ClipGradByNorm, 0.8),
        "value": (ref.nn.ClipGradByValue, ClipGradByValue, 0.3)}[kind]
    gs = [_grad(s, 0, i, 2.0) for i, s in enumerate(SHAPES)]
    rps = _ref_params(ref)
    pps = [torch.zeros(s) for s in SHAPES]
    for p in (rps[1], rps[3], pps[1], pps[3]):
        p.need_clip = False
    want = ref_cls(arg)([(p, ref.to_tensor(g)) for p, g in zip(rps, gs)])
    pairs = [(p, torch.from_numpy(g)) for p, g in zip(pps, gs)]
    got = port_cls(arg)(pairs)
    for (_, a), (_, r), (_, g0) in zip(got, want, pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(r.numpy()), **REF_TOL)
    assert got[1][1] is pairs[1][1] and got[3][1] is pairs[3][1]
    assert not torch.equal(got[0][1], pairs[0][1])
    want = _clip_grads_functional([jnp.asarray(g) for g in gs],
                                  ref_cls(arg))
    got = port_cls(arg).clip_grads([torch.from_numpy(g) for g in gs])
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **REF_TOL)


# ---------------------------------------------------------- TrainStep --

def _tiny_step(fused, dtype="bfloat16", need_clip_off=False):
    port_set_flags({"fused_optimizer": fused})
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype), device="cpu") \
        .init_weights(torch.Generator().manual_seed(0))
    if need_clip_off:
        model.lm_head.weight.need_clip = False
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda n: "norm" not in n)
    crit = LlamaPretrainingCriterion()
    poison = {"on": False}

    def loss_fn(logits, labels):
        loss = crit(logits, labels)
        return loss * float("nan") if poison["on"] else loss
    return model, opt, TrainStep(model, opt, loss_fn), poison


def _state_snapshot(model, step):
    out = [p.detach().clone() for p in model.parameters()]
    for st in step.opt_state:
        out += [st[k].clone() for k in sorted(st)]
    return out


@pytest.mark.parametrize("need_clip_off", [False, True],
                         ids=["clip_all", "need_clip_off"])
def test_train_step_fused_matches_per_param_with_guard(need_clip_off):
    """Two TrainSteps, a NaN-loss step and one more: the fused path equals
    the per-parameter path bit for bit after each; the NaN step leaves
    every parameter, master, moment and step counter as it was. The
    structured names reach apply_decay_param_fun (norm weights take no
    decay), and a need_clip=False parameter is clipped all the same."""
    ids = np.random.RandomState(6).randint(0, 256, (2, 12))
    snaps = []
    for fused in (True, False):
        model, opt, step, poison = _tiny_step(fused,
                                              need_clip_off=need_clip_off)
        before = dict(dispatch_counts)
        run = []
        for i in range(4):
            poison["on"] = i == 2
            step(ids, ids)
            run.append(_state_snapshot(model, step))
        used = {k: dispatch_counts[k] - before[k] for k in before}
        if fused:
            assert used == {"fused": 4, "per_param": 0}
            wd = dict(zip(step._p_names, step._plan.table.coeffs["wd"]))
            assert wd["llama.norm.weight"] == 0.0
            assert wd["lm_head.weight"] == 0.1
        else:
            assert used["fused"] == 0
        _bitwise(run[1], run[2])        # the NaN step changed nothing
        assert int(step.opt_state[0]["step"]) == 3
        snaps.append(run)
    for a, b in zip(*snaps):
        _bitwise(a, b)


def test_train_step_matches_reference_fused_update(ref):
    """One f32 TrainStep's update against the reference's functional
    AdamW applied to the same gradients (the reference's TrainStep runs
    this update inside its program)."""
    import jax.numpy as jnp
    from paddle_tpu.jit.bridge import _clip_grads_functional
    from paddle_tpu.optimizer import AdamW as RefAdamW
    model, opt, step, _ = _tiny_step(True, dtype="float32")
    names = list(step._p_names)
    w0 = [p.detach().numpy().copy() for p in model.parameters()]
    ids = np.random.RandomState(7).randint(0, 256, (2, 12))
    step(ids, ids)
    grads = [p.grad.numpy() for p in model.parameters()]
    ropt = RefAdamW(learning_rate=1e-3, parameters=[], weight_decay=0.1,
                    apply_decay_param_fun=lambda n: "norm" not in n)
    rs = ropt._fn_init_all([jnp.asarray(w) for w in w0], names)
    rg = _clip_grads_functional([jnp.asarray(g) for g in grads],
                                ref.nn.ClipGradByGlobalNorm(1.0))
    rp, _ = ropt._fn_apply_all([jnp.asarray(w) for w in w0], rg, rs,
                              jnp.float32(1e-3), names)
    for p, r, n in zip(model.parameters(), rp, names):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


# --------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# Kernel vs plain on the card. f32: the same ops in the same order
# (IEEE division and square root, no FMA contraction), so only powf's and
# the norm's summation order can differ: a few f32 ulps. bf16 / f16
# parameters with f32 masters: the masters as f32, the parameters at most
# one ulp apart where a master lies at a rounding boundary (bf16 2^-7,
# f16 2^-10 of the value). bf16 / f16 without masters: every op rounded
# to the parameter's type, and operands the plain version rounds (lr,
# beta in pow) may round at another place: a few ulps (bf16's tolerance
# scaled by the ulp ratio for f16); there beta2 = 0.999 rounds to 1 in
# bf16, so Adam's bias correction 1 - beta2^t is 0 and an element with a
# zero moment is NaN on both sides (the reason the reference defaults to
# master weights for bf16); in f16 a clipped gradient's square underflows,
# so the same holds there. atol is held relative to each buffer's largest
# magnitude (``_card_close``): a clipped step's moment2 is ~1e-8 here.
CARD_TOL = {"f32": dict(rtol=1e-5, atol=1e-6),
            "bf16_master": dict(rtol=1e-5, atol=1e-6),
            "f16_master": dict(rtol=1e-5, atol=1e-6),
            "bf16_param": dict(rtol=8e-3, atol=1e-5),
            "f16_param": dict(rtol=1e-3, atol=1e-5),
            "bf16": dict(rtol=2e-2, atol=1e-3, equal_nan=True),
            "f16": dict(rtol=2.5e-3, atol=1.25e-4, equal_nan=True)}
# clip scales, kernel vs plain: the global one from f32 sums in another
# order (a few f32 ulps); a tensor's own from its norm rounded to the
# gradient's type, one ulp of which moves the scale by up to two
SCALE_TOL = {"global": dict(rtol=1e-5, atol=0),
             torch.float32: dict(rtol=1e-5, atol=0),
             torch.bfloat16: dict(rtol=2 * 2 ** -7, atol=0),
             torch.float16: dict(rtol=2 * 2 ** -10, atol=0)}
CARD_DTYPE = {"f32": torch.float32, "bf16_master": torch.bfloat16,
              "bf16": torch.bfloat16, "f16_master": torch.float16,
              "f16": torch.float16}
# widths not a multiple of 8, a chunk boundary, short vectors
CARD_SHAPES = ((37, 129), (1000,), (3, 5), (2, fk.CHUNK + 13), (8,))


def _card_opt(case, mode, cuda, clip):
    cls, kw = CASES[case]
    ps = _params(CARD_SHAPES, CARD_DTYPE[mode], cuda)
    extra = {} if mode not in ("bf16", "f16") else {"multi_precision": False}
    opt = cls(learning_rate=0.05, parameters=ps, grad_clip=clip, **kw,
              **extra)
    return ps, opt


def _card_grads(ps, step):
    return [torch.from_numpy(_grad(tuple(p.shape), step, i, 3.0))
            .to(p.device, p.dtype) for i, p in enumerate(ps)]


def _card_close(got, want, rtol, atol, equal_nan=False):
    """assert_close with atol times min(1, want's largest finite
    magnitude): each buffer is held at its own size (a moment of 1e-8 is
    not within an atol of 1e-6 of anything), none more loosely than at
    atol."""
    got, want = got.float(), want.float()
    fin = want[torch.isfinite(want)]
    size = min(1.0, float(fin.abs().max())) if fin.numel() else 1.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * size,
                               equal_nan=equal_nan)


def _buffers(ps, opt):
    out = [p.detach().clone() for p in ps]
    for p in ps:
        st = opt._state_of(p)
        out += [st[k].clone() for k in sorted(st)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16_master", "bf16",
                                  "f16_master", "f16"])
@pytest.mark.parametrize("clip", [None, "global", "norm", "value"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case, clip, mode):
    """Three steps of the kernels against three of their plain versions
    on the card, same inputs; a second kernel run on copies equals the
    first bit for bit. With a norm clip the plain update takes the
    kernel's clip scales, each held to the plain scales first: a tensor's
    own norm is rounded to the gradient's type, so a sum in another order
    can move it, and the scale, by an ulp (f16, ``norm``), which every
    buffer after it would carry; the update is held to its plain version
    on equal inputs."""
    clip_obj = {None: None, "global": ClipGradByGlobalNorm(1.0),
                "norm": ClipGradByNorm(0.8),
                "value": ClipGradByValue(0.5)}[clip]
    runs = []
    for how in ("kernel", "plain", "kernel"):
        ps, opt = _card_opt(case, mode, cuda, clip_obj)
        plan = None
        reset_launch_counts()
        for s in range(3):
            grads = _card_grads(ps, s)
            plan = fused_plan(opt, ps, grads, cached=plan)
            lr = opt._lr_operand(cuda)
            if how == "kernel":
                plan.run(grads, lr)
            else:
                scales = None
                if plan.table.clip_mode == fk.CLIP_SCALE:
                    scales = fk.grad_sq_norm_kernel(plan.table, grads)[1]
                    torch.testing.assert_close(
                        scales, fk.grad_sq_norm_plain(plan.table, grads)[1],
                        **SCALE_TOL[clip if clip == "global"
                                    else CARD_DTYPE[mode]])
                fk.fused_update_plain(plan.table, grads, lr, scales)
        torch.cuda.synchronize()
        if how == "kernel":
            assert launch_counts["fused_update"] == 3
            assert launch_counts["grad_sq_norm"] == (
                3 if clip in ("global", "norm") else 0)
        runs.append(_buffers(ps, opt))
    n = len(CARD_SHAPES)
    for i, (a, b) in enumerate(zip(runs[0], runs[1])):
        tol = CARD_TOL[mode if i >= n or not mode.endswith("_master")
                       else mode.replace("_master", "_param")]
        _card_close(a, b, **tol)
    _bitwise(runs[0], runs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("per_tensor", [False, True], ids=["global", "own"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_grad_sq_norm_matches_plain(cuda, dtype, per_tensor):
    ps, opt = _card_opt("adam", "f32", cuda,
                        ClipGradByNorm(0.8) if per_tensor
                        else ClipGradByGlobalNorm(1.0))
    grads = [g.to(dtype) for g in _card_grads(ps, 0)]
    plan = fused_plan(opt, ps, grads)
    got = [fk.grad_sq_norm(plan.table, grads) for _ in range(2)]
    want = fk.grad_sq_norm_plain(plan.table, grads)
    torch.cuda.synchronize()
    # a tensor's own norm is rounded to the gradient's type: one ulp
    tol = dict(rtol=1e-5, atol=0) if dtype == torch.float32 or \
        not per_tensor else dict(rtol={torch.bfloat16: 8e-3,
                                       torch.float16: 1e-3}[dtype], atol=0)
    for a, b in zip(got[0], want):
        torch.testing.assert_close(a, b, **tol)
    _bitwise(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16_master"])
def test_guard_leaves_every_buffer(cuda, mode):
    ps, opt = _card_opt("adamw", mode, cuda, ClipGradByGlobalNorm(1.0))
    grads = _card_grads(ps, 0)
    plan = fused_plan(opt, ps, grads)
    plan.run(grads, opt._lr_operand(cuda))
    before = _buffers(ps, opt)
    plan.run(_card_grads(ps, 1), opt._lr_operand(cuda),
             bad=torch.tensor(True, device=cuda))
    torch.cuda.synchronize()
    _bitwise(before, _buffers(ps, opt))
    plan.run(_card_grads(ps, 1), opt._lr_operand(cuda),
             bad=torch.tensor(False, device=cuda))
    assert int(opt._state_of(ps[0])["step"]) == 2


@pytest.mark.cuda
def test_unaligned_views(cuda):
    """Parameters and gradients that start off a 16-byte boundary: a
    common phase (head of scalars) and none (all scalars)."""
    big = torch.randn(5000, device=cuda)
    gbig = torch.randn(5000, device=cuda)
    runs = []
    for how in ("kernel", "plain"):
        base = big.clone()
        ps = [base[1:1001], base[2003:2003 + 777]]
        grads = [gbig[1:1001], gbig[3000:3777]]   # phase 3; no phase
        opt = SGD(0.1, parameters=ps, weight_decay=0.01)
        plan = fused_plan(opt, ps, grads)
        if how == "kernel":
            plan.run(grads, opt._lr_operand(cuda))
        else:
            fk.fused_update_plain(plan.table, grads, opt._lr_operand(cuda))
        runs.append([p.clone() for p in ps])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        _card_close(a, b, **CARD_TOL["f32"])


@pytest.mark.cuda
def test_eager_step_and_train_step_launch_once_per_step(cuda):
    """On the card the eager step() and TrainStep each launch
    fused_update once per step (and grad_sq_norm once with a norm clip),
    and agree with the CPU's per-parameter path."""
    pc, _ = _run_port("adamw", False, grad_clip=ClipGradByGlobalNorm(1.0),
                      scale=3.0)
    port_set_flags({"fused_optimizer": True})
    cls, kw = CASES["adamw"]
    ps = _params(device=cuda)
    opt = cls(learning_rate=0.05, parameters=ps,
              grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    reset_launch_counts()
    for s in range(3):
        _set_grads(ps, s, 3.0)
        opt.step()
    torch.cuda.synchronize()
    assert launch_counts["fused_update"] == 3
    assert launch_counts["grad_sq_norm"] == 3
    for a, b in zip(ps, pc):
        _card_close(a.detach().cpu(), b.detach(), **CARD_TOL["f32"])
    # head_dim 64: the flash kernels take 64 and 128
    model = LlamaForCausalLM(LlamaConfig.tiny(num_attention_heads=2,
                                              num_key_value_heads=2),
                             device=cuda) \
        .init_weights(torch.Generator(device=cuda).manual_seed(0))
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    crit = LlamaPretrainingCriterion()
    step = TrainStep(model, opt, lambda lg, lb: crit(lg, lb))
    ids = np.random.RandomState(6).randint(0, 256, (2, 12))
    reset_launch_counts()
    for _ in range(2):
        step(ids, ids)
    torch.cuda.synchronize()
    assert launch_counts["fused_update"] == 2
    assert launch_counts["grad_sq_norm"] == 2
