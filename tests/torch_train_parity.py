"""Whole-model training parity at smoke size, shared by
``test_torch_train_models.py`` (the dense attention archs) and
``test_torch_train_families.py`` (MoE, Mamba2 and xLSTM), which split the
ten archs so that each file stays well under a minute: the reference's
jitted gradients and step are most of the time.

Each arch's module fixture ``case`` (``make_case``) carries the
reference's weights across (``models/convert.py``), draws tokens and
labels from a numpy seed, and runs the reference once: ``lm.forward``'s
hidden states, ``lm.loss_fn`` and its gradients, and one
``make_train_step`` step from a fresh AdamW state.  gemma3, zamba2 and
xlstm are cut to one block of each kind
(``torch_parity.smoke_cfgs(arch, kinds=True)``), so that gemma's global
layer, zamba2's shared attention and xlstm's sLSTM run.  Remat is "none"
on both sides here (it changes no number; the port's three policies are
held to each other in ``test_torch_training.py``).

Tolerances, fp32 on the CPU (summation order of einsums, matmuls and the
loss's sums): hidden states within rtol 1e-5 / atol 1e-5; the loss within
1e-5 relative; each gradient leaf within rtol 1e-4 and an atol of 1e-5
of that leaf's largest magnitude; the step's gnorm within 1e-4 relative,
its lr and count equal, and the updated params within 1e-6 of the
reference's plus what the gradient tolerance allows through AdamW's
first step: that step moves a param by ``lr * u(g)``, ``u(g) = g s /
(|g| s + eps)`` with ``s`` the clip scale, which is +-1 for most
gradients but turns one at noise level (a key bias's, whose true
gradient is zero) into anything in between, so each element may differ
by ``lr * (u(g + d) - u(g - d))``, ``d`` the gradient tolerance at the
reference's ``g``."""
import jax
import numpy as np
import torch

from repro.models import layers as jL
from repro.models import lm as jlm
from repro.training.optimizer import init_opt_state as jinit_opt_state
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import make_train_step as jmake_train_step

from repro_torch.core.descriptor import flatten_with_names, unflatten_from_paths
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import TrainConfig, make_train_step

from torch_parity import smoke_cfgs

KINDS = ("gemma3-1b", "zamba2-2.7b", "xlstm-1.3b")
B, S, XENT = 2, 32, 24          # 24: one chunk of the loss and a remainder
STEP = dict(microbatches=1, q_chunk=S, xent_chunk=XENT, warmup=0,
            peak_lr=1e-3, remat="none")


def tokens(cfg, seed, batch=B):
    shape = (batch, S) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                          else ())
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def make_case(arch, batch=B):
    """One arch: the port's config and params, tokens and labels, and the
    reference's hidden states, loss, gradients and one train step, from one
    jitted call."""
    jc, tc = smoke_cfgs(arch, kinds=arch in KINDS)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tok, lab = tokens(jc, 1, batch), tokens(jc, 2, batch)
    jstep = jmake_train_step(jc, JTrainConfig(**STEP))

    def loss_and_hidden(p):          # lm.loss_fn, its hidden states kept
        h = jlm.forward(p, jc, tok, remat="none")
        return jL.chunked_xent(p["embed"], jc, h, lab, chunk=XENT), h

    def reference(p):
        return (jax.value_and_grad(loss_and_hidden, has_aux=True)(p),
                jstep(p, jinit_opt_state(p), tok, lab))

    ((loss, h), grads), (p2, o2, m) = jax.jit(reference)(jp)
    host = lambda t: jax.tree.map(np.asarray, t)
    return dict(arch=arch, tc=tc, tp=params_from_numpy(host(jp), "cpu"),
                tok=torch.from_numpy(tok), lab=torch.from_numpy(lab),
                h=np.asarray(h), loss=float(loss), grads=host(grads),
                step_params=host(p2), step_count=int(o2["count"]),
                step_metrics={k: float(v) for k, v in m.items()})


def test_forward_matches_reference(case):
    with torch.no_grad():
        h = lm.forward(case["tp"], case["tc"], case["tok"], remat="none")
    assert h.shape == (B, S, case["tc"].d_model)
    np.testing.assert_allclose(h.numpy(), case["h"], rtol=1e-5, atol=1e-5)


def test_loss_matches_reference(case):
    with torch.no_grad():
        loss = lm.loss_fn(case["tp"], case["tc"], case["tok"], case["lab"],
                          remat="none", xent_chunk=XENT)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - case["loss"]) <= 1e-5 * abs(case["loss"])


def test_grads_match_reference(case):
    _, paths, leaves = flatten_with_names(case["tp"])
    xs = [p.detach().requires_grad_() for p in leaves]
    loss = lm.loss_fn(unflatten_from_paths(paths, xs), case["tc"],
                      case["tok"], case["lab"], remat="none",
                      xent_chunk=XENT)
    grads = torch.autograd.grad(loss, xs)
    names, _, want = flatten_with_names(case["grads"])
    assert len(want) == len(grads)
    for name, g, w in zip(names, grads, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
            err_msg=f"{case['arch']} {name}")


def step_bound(g, lr, gnorm):
    """How far an element's first AdamW step may move, elementwise, over
    the gradients within tolerance of the reference's ``g``."""
    s = min(1.0, 1.0 / (gnorm + 1e-9))
    d = 1e-4 * np.abs(g) + 1e-5 * np.abs(g).max()
    u = lambda x: x * s / (np.abs(x) * s + 1e-8)
    return 1e-6 + lr * (u(g + d) - u(g - d))


def test_train_step_matches_reference(case):
    params = params_from_numpy(
        jax.tree.map(lambda t: t.numpy(), case["tp"]), "cpu")
    opt = init_opt_state(params)
    step = make_train_step(case["tc"], TrainConfig(**STEP))
    p2, o2, m = step(params, opt, case["tok"], case["lab"])
    want = case["step_metrics"]
    assert abs(float(m["loss"]) - want["loss"]) <= 1e-5 * want["loss"]
    assert abs(float(m["gnorm"]) - want["gnorm"]) <= 1e-4 * want["gnorm"]
    assert float(m["lr"]) == want["lr"]
    assert int(o2["count"]) == case["step_count"] == 1
    names, _, got = flatten_with_names(p2)
    wnames, _, wleaves = flatten_with_names(case["step_params"])
    assert names == wnames
    grads = flatten_with_names(case["grads"])[2]
    for name, g, w, gw in zip(names, got, wleaves, grads):
        bound = step_bound(gw, want["lr"], want["gnorm"])
        excess = np.abs(g.numpy() - w) - bound
        assert excess.max() <= 0, (case["arch"], name, excess.max())
