"""Parity on the configs' default compute dtype, bfloat16: one arch per
block family at smoke size (gemma3-1b: window and global attention;
moonshot-v1-16b-a3b: MoE; zamba2-2.7b and xlstm-1.3b cut to one block of
each kind), a prefill of 16 tokens and 3 decode steps.

The tolerance is derived from the reference's own bfloat16 noise on the
same inputs and float32 params: the port's bf16 logits may lie at most
``NOISE_FACTOR`` times as far from the reference's bf16 logits as those
lie from the reference's fp32 logits."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402

from repro_torch.models import lm  # noqa: E402

from torch_parity import smoke_cfgs  # noqa: E402

NOISE_FACTOR = 2.0
B, PROMPT, DECODE = 2, 16, 3
ARCHS = ["gemma3-1b", "moonshot-v1-16b-a3b", "zamba2-2.7b:kinds",
         "xlstm-1.3b:kinds"]

_jprefill = jax.jit(jlm.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(1,))


def _ref_logits(params, cfg, toks):
    """The reference's logits of the prefill and each decode step,
    stacked (float32)."""
    S = toks.shape[1]
    log, cache = _jprefill(params, cfg, jnp.asarray(toks[:, :PROMPT]), S)
    out = [log]
    for t in range(PROMPT, S):
        pos = jnp.full((B,), t, jnp.int32)
        log, cache = _jdecode(params, cfg, cache, jnp.asarray(toks[:, t]),
                              pos)
        out.append(log)
    return np.stack([np.asarray(x, np.float32) for x in out])


def _port_logits(params, cfg, toks):
    S = toks.shape[1]
    log, cache = lm.prefill(params, cfg, torch.from_numpy(toks[:, :PROMPT]),
                            S)
    out = [log]
    for t in range(PROMPT, S):
        pos = torch.full((B,), t, dtype=torch.int32)
        log, cache = lm.decode_step(params, cfg, cache,
                                    torch.from_numpy(toks[:, t]), pos)
        out.append(log)
    return np.stack([x.float().numpy() for x in out])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_the_references_bf16_noise(arch):
    name, _, kinds = arch.partition(":")
    jc16, tc16 = smoke_cfgs(name, kinds=bool(kinds),
                            compute_dtype="bfloat16")
    jc32, _ = smoke_cfgs(name, kinds=bool(kinds))
    # float32 params (the configs' param dtype), drawn by the port's init
    # and carried to the reference: its eager init takes seconds per arch
    tparams = lm.init_params(tc16, torch.Generator().manual_seed(1), "cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    toks = np.random.default_rng(7).integers(
        0, tc16.vocab_size, (B, PROMPT + DECODE)).astype(np.int32)

    ref16 = _ref_logits(jparams, jc16, toks)
    ref32 = _ref_logits(jparams, jc32, toks)
    port16 = _port_logits(tparams, tc16, toks)
    assert port16.shape == ref16.shape == (DECODE + 1, B, tc16.vocab_size)
    noise = float(np.abs(ref16 - ref32).max())
    err = float(np.abs(port16 - ref16).max())
    assert 0 < noise and np.isfinite(port16).all()
    assert err <= NOISE_FACTOR * noise, (err, noise)
