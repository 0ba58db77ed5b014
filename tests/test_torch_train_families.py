"""Training parity of the MoE, Mamba2 and xLSTM archs against the
reference at smoke size: forward, loss, gradients and one train step
(tolerances in ``torch_train_parity``)."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_parity import (make_case,  # noqa: E402,F401
                                test_forward_matches_reference,
                                test_grads_match_reference,
                                test_loss_matches_reference,
                                test_train_step_matches_reference)


@pytest.fixture(scope="module", params=[
    "zamba2-2.7b", "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "xlstm-1.3b"])
def case(request):
    return make_case(request.param)
