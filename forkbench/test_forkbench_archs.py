"""The architecture modules (``forkbench/archs``) against what the harness
computed when it knew one block shape only: for the existing
configurations, weights bit-equal, reference logits bit-equal, the same
program config and the same roofline counts, each held against a digest
or value taken from that harness on the CPU."""
import hashlib
import json

import pytest

from forkbench import archs, harness, roofline
from forkbench import weights as W
from forkbench.conftest import BENCH, tiny_config

SEEDS = (3, 2 ** 31 + 5)
# sha256 (first 32 hex digits) of every leaf's name, shape and bytes, and
# of the reference's fp32 and tf32 logits over a 40-token prompt and 6
# served tokens (``_digests``)
DIGESTS = {
    ("dense", 3): ("47d992f265b4877eb013ea5d05138deb",
                   "454c64f9ace387381b0f443809171677",
                   "ef96fc942e42fe7559d8adeeb5b2e1b7"),
    ("dense", 2 ** 31 + 5): ("c52503499155f2da61829609001e94de",
                             "fa45dcfb8ca109854b172786c8b6e586",
                             "f117fb3d2c35bc1448849f4b9a7353c5"),
    ("moe", 3): ("2c2a81c1ce4cdbc27d17aea0a1862168",
                 "5b85d664512032febbb4009d903d2139",
                 "13b16d75cc471a2b47335ddde18364d1"),
    ("moe", 2 ** 31 + 5): ("7f04b60409c33ada691149653de197c0",
                           "52c170ce3ca1277e69d0983069925d28",
                           "793e19fda5f16ecc9fca4becd9e83663"),
}
# sha256 of the program config's repr
PORTS = {"dense": "b453abe4464007b41922e496d307b30e",
         "moe": "d73b1c7c9347f10bfefbbab7de18bb76",
         "stablelm-3b": "e0e669d7e1d8b20a38a7a69f2f35d6c7",
         "mixtral-8x7b-2L": "d1efc16d3ce71271bbe255c675fc4d77"}
# param_count, block_params (active, all), state_bytes, fork_least_s,
# prefill_least_s at 32 and 1024, decode_least_s at 33 and 1056,
# attention_bytes and serve_least_s of a 256-token prompt and 20 tokens
COUNTS = {
    "stablelm-3b": [2795276800, 2537720320, 2537720320, 11181107200,
                    0.006675287880597015, 0.003190236847761194,
                    0.08014142143044777, 0.003190533349253731,
                    0.0033906626865671642, 3324641280, 0.08104364551641792],
    "mixtral-8x7b-2L": [3164688384, 788615168, 2902544384, 12658753536,
                        0.00755746479761194, 0.0010984469397014925,
                        0.024366308275582088, 0.0010983051080597015,
                        0.0011033083414925373, 84049920,
                        0.026935881911402986]}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:32]


def _digests(m: dict, seed: int):
    import torch
    w = W.make(m, seed, "cpu")
    h = hashlib.sha256()
    for name, t in W.flat(w):
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    g = torch.Generator().manual_seed(seed % 1000)
    prompt = torch.randint(0, m["vocab_size"], (40,), generator=g).tolist()
    served = torch.randint(0, m["vocab_size"], (6,), generator=g).tolist()
    ref = archs.load(m).Reference
    return (h.hexdigest()[:32],) + tuple(
        _sha(ref(m, w, precision=p).logits(prompt, served).numpy().tobytes())
        for p in ("fp32", "tf32"))


def _real(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _tiny(kind: str) -> dict:
    """The tiny configuration of the dense or the MoE kind, the twin of
    the real configuration of that kind."""
    real = _real("mixtral-8x7b-2L" if kind == "moe" else "stablelm-3b")
    return tiny_config("tiny", real)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_weights_and_reference_logits_are_bit_equal(kind, seed):
    m = _tiny(kind)["model"]
    assert "arch" not in m and archs.load(m).__name__.endswith(".gqa_moe")
    assert _digests(m, seed) == DIGESTS[kind, seed]


@pytest.mark.parametrize("name", sorted(PORTS))
def test_the_program_config_is_the_same(name):
    conf = _tiny(name) if name in ("dense", "moe") else _real(name)
    assert _sha(repr(harness.port_config(conf)).encode()) == PORTS[name]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_the_roofline_counts_are_the_same(name):
    m = _real(name)["model"]
    assert [W.param_count(m), roofline.block_params(m),
            roofline.block_params(m, active=False), roofline.state_bytes(m),
            roofline.fork_least_s(m), roofline.prefill_least_s(m, 32),
            roofline.prefill_least_s(m, 1024), roofline.decode_least_s(m, 33),
            roofline.decode_least_s(m, 1056),
            roofline.attention_bytes(m, 256, 20),
            roofline.serve_least_s(m, 256, 20)] == COUNTS[name]


def test_an_arch_is_a_module_name():
    with pytest.raises(ValueError):
        archs.load({"arch": "../gqa_moe"})
    with pytest.raises(ModuleNotFoundError):
        archs.load({"arch": "no_such_arch"})
