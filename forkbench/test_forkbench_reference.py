"""The plain reference against the program's model at tiny sizes on the
CPU: the prompt's prefill and each decode step through the cache
(``repro_torch.models.lm``), dense and MoE, the MoE prompts long enough
that experts drop tokens past their capacity."""
import pytest
import torch

from forkbench import harness
from forkbench import weights as W
from forkbench.conftest import CONFS
from forkbench.reference.model import Reference, round_tf32


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_reference_matches_the_program(moe, seed):
    from repro_torch.models import lm
    conf = CONFS["tiny-mixtral-8x7b-2L" if moe
                 else "tiny-stablelm-3b"]
    m, cfg = conf["model"], harness.port_config(conf)
    w = W.make(m, seed, "cpu")
    g = torch.Generator().manual_seed(seed % 1000)
    prompt = torch.randint(0, m["vocab_size"], (40,), generator=g).tolist()
    served = torch.randint(0, m["vocab_size"], (6,), generator=g).tolist()
    logits, caches = lm.prefill(w, cfg, torch.tensor([prompt]), 48)
    rows = [logits[0]]
    for i, t in enumerate(served[:-1]):
        logits, caches = lm.decode_step(w, cfg, caches, torch.tensor([t]),
                                        torch.tensor([len(prompt) + i]))
        rows.append(logits[0])
    want = Reference(m, w).logits(prompt, served)[len(prompt) - 1:]
    torch.testing.assert_close(torch.stack(rows), want, atol=2e-5, rtol=1e-5)
    if moe:     # the prompt's experts dropped tokens past their capacity
        roomy = Reference(dict(m, moe_capacity_factor=100.0), w)
        assert not torch.allclose(
            roomy.logits(prompt, served)[len(prompt) - 1:], want)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12])
    got = round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]
