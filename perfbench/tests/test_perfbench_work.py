"""The work counts behind the rooflines and step_mfu, on hand-computed
small shapes."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import work as W  # noqa: E402


def test_least_time_takes_the_larger_bound():
    assert W.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert W.least_s(0, 67e12) == pytest.approx(1.0)
    assert W.least_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_huffman_kernel_counts():
    # 2 chunks of 4 symbols: lens + codes read (8 B a slot), 3 stream words
    # written, plus 4 B of chunk bits each
    assert W.huffman_encode_bytes(2, 4, 3) == 64 + 12 + 8
    assert W.huffman_encode_ops(2, 4) == 96


def test_enhancer_flop_counts_hidden_values_a_group_needs():
    # one 1x4x4 slice: group 0 in column 0, group 1 elsewhere
    ids = torch.ones((1, 4, 4), dtype=torch.int32)
    ids[0, :, 0] = 0
    C = 2
    # group 0: 4 outputs; its 3x3 neighbourhoods cover columns 0-1: 8 hidden
    assert W.enhancer_flop(ids, [0], C) == 2 * 9 * C * (8 + 4)
    # group 1: 12 outputs; neighbourhoods cover all 16 pixels
    assert W.enhancer_flop(ids, [1], C) == 2 * 9 * C * (16 + 12)
    assert W.enhancer_flop(ids, [0, 1], C) == 2 * 9 * C * (8 + 4 + 16 + 12)
    assert W.enhancer_fused_bytes(16, 2, C) == 12 * 16 + 4 * 2 * (4 + 21 * C)


def test_whole_op_counts():
    fwd = 2 * 18 * 9
    assert W.enhancer_forward_flop_per_value(9) == fwd == 324
    # 10 values, 2 epochs: 3 fwd an epoch, conv1 once, gate + enhance
    assert W.gwlz_write_flop(10, 9, 2) == 10 * (3 * 324 * 2 + 162 + 2 * 324)
    assert W.write_bytes(10, 7) == 47 and W.read_bytes(10, 7) == 47

