"""test_torch_port_decode_train.py's training holds for the ``decode``
CLI's variant c, DeepSleepNet (one step's loss, gradients and BatchNorm
statistics against JAX's; ``train_decoder`` over one and three epochs),
in a file of their own: JAX's compile of DeepSleepNet's step is most of
their time."""
import pytest
import torch

import test_torch_port_decode_train as T
from test_torch_port_decode_train import no_jax_dropout  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_step_matches_jax(no_jax_dropout):  # noqa: F811
    T.test_train_step_matches_jax("deepsleepnet", no_jax_dropout)


@pytest.mark.parametrize("n_epochs", [1, 3])
def test_train_decoder_matches_jax(n_epochs, no_jax_dropout, monkeypatch):  # noqa: F811
    T.test_train_decoder_matches_jax("deepsleepnet", n_epochs, no_jax_dropout, monkeypatch)
