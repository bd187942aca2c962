"""Port parity for Gluon's model zoo, part d: Inception v3 at its full input
(299x299: its last pool needs it), batch 1, 10 classes, through part a's
``zoo_parity`` (logits, one step; recorded in predict mode for its Dropout). The JAX net is hybridized: one
compile of the whole graph instead of one per op.
"""
import pytest
import torch

from test_torch_model_zoo_a import zoo_parity


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_inception_v3_matches_the_reference():
    zoo_parity("inception_v3", 299, False, jax_hybrid=True)
