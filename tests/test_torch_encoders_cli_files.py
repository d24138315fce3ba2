"""The port's CLI against qagnn_tpu.cli.train for the LSTM, whose word ids
come from a `--lstm_vocab` file that `make_word_vocab` writes, and for a
tiny ALBERT read through `--encoder_load` from an HF directory (CPU, f32):
tests/test_torch_encoders_cli.py's check, its losses within rtol 2e-4.
"""

import pytest

from test_torch_cli import _no_dropout, _one_torch_thread  # noqa: F401
from test_torch_encoders_cli import train_matches_the_jax_cli


@pytest.mark.parametrize("encoder", ["tiny-lstm", "albert"])
def test_train_matches_the_jax_cli(tmp_path, monkeypatch, _no_dropout,
                                   encoder):
    train_matches_the_jax_cli(tmp_path, monkeypatch, encoder)
