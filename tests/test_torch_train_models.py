"""Training parity of the dense attention archs against the reference at
smoke size: forward, loss, gradients and one train step
(``torch_parity``'s scaffolding; tolerances in ``torch_train_parity``)."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_parity import (make_case,  # noqa: E402,F401
                                test_forward_matches_reference,
                                test_grads_match_reference,
                                test_loss_matches_reference,
                                test_train_step_matches_reference)


@pytest.fixture(scope="module", params=[
    "stablelm-3b", "gemma3-1b", "granite-34b", "qwen2-7b", "musicgen-large",
    "chameleon-34b"])
def case(request):
    return make_case(request.param)
