"""The useful-work count against a hand count on a tiny kernel map."""

from __future__ import annotations

import torch

from port_bench import work
from port_bench.reference.nn import sparse_ops


def test_useful_ops_and_bytes_match_a_hand_count():
    # 3 output rows (the last invalid), kernel volume 2, 4 input rows
    kmap = torch.tensor([[0, -1], [2, 1], [3, 0]], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    feats = torch.randn(4, 5)
    w = torch.randn(2, 5, 7)
    with work.WorkCount(operand_bytes=2) as wc:
        y = sparse_ops.gather_conv(feats, kmap, w, valid)
    # present entries on valid rows: (0,0), (1,0), (1,1) -> 3
    assert wc.ops() == 2 * 5 * 7 * 3
    # inputs read: rows 0, 1, 2 -> 3 rows of 5 bf16; weights 2*5*7 bf16; 2 valid outputs of 7 f32
    assert wc.bytes() == (3 * 5 + 2 * 5 * 7) * 2 + 2 * 7 * 4
    assert torch.allclose(y[1], feats[2] @ w[0] + feats[1] @ w[1], atol=1e-5)
    assert torch.equal(y[2], torch.zeros(7))


def test_dense_layers_count_their_valid_rows_and_stages_apart():
    valid = torch.tensor([True, False, True])
    with work.WorkCount() as wc:
        work.dense(valid, 4, 3)
        wc.stage = "two"
        work.dense(valid, 4, 3)
    assert wc.ops() == 2 * (2 * 4 * 3 * 2) and wc.ops("two") == 2 * 4 * 3 * 2


def test_attention_counts_the_keys_of_valid_query_rows():
    valid = torch.tensor([True, True, False, True])
    with work.WorkCount(operand_bytes=2) as wc:
        work.attention(valid, torch.tensor([3, 1, 4, 2]), heads=2, head_dim=8)
        wc.stage = "two"
        work.attention(valid, 5, heads=2, head_dim=8)
    # keys on valid rows: 3 + 1 + 2; QK^T and AV: 4 * head_dim * heads per key
    assert wc.ops() - wc.ops("two") == 4 * 6 * 8 * 2
    assert wc.ops("two") == 4 * 15 * 8 * 2
    # Q, K and V of the 3 valid rows read once, their output written once, 16 bf16 a row
    assert wc.bytes("two") == 4 * 3 * 16 * 2
