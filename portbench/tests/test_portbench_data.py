"""The generators repeat from a seed, and the held-out items keep their
law's promises."""

import numpy as np
import pytest
import torch

from portbench.data import synth


def test_sub_seeds_take_wide_seeds_and_split_streams():
    a = synth.sub_seed(2**31 + 12345, "model")
    assert a == synth.sub_seed(2**31 + 12345, "model")
    assert a != synth.sub_seed(2**31 + 12345, "interactions")
    assert a != synth.sub_seed(12345, "model")
    assert 0 <= synth.sub_seed(2**40 + 7, "x") < 2**32


@pytest.mark.parametrize("seed", [3, 4])
def test_generators_repeat_from_a_seed(seed):
    a, ca = synth.clustered_interactions(500, 6400, 8000, seed)
    b, cb = synth.clustered_interactions(500, 6400, 8000, seed)
    c, _ = synth.clustered_interactions(500, 6400, 8000, seed + 1)
    assert (a != b).nnz == 0 and (ca == cb).all() and (a != c).nnz > 0
    h = synth.held_out(a.tocsr(), ca, 100, 10, seed)
    assert (h != synth.held_out(a.tocsr(), ca, 100, 10, seed)).nnz == 0
    u1, i1 = synth.planted_tables(torch, 500, 6400, 8, 16, ca, 64, seed, "cpu")
    u2, i2 = synth.planted_tables(torch, 500, 6400, 8, 16, ca, 64, seed, "cpu")
    assert torch.equal(u1, u2) and torch.equal(i1, i2)
    assert (u1[:, 8:15] == 0).all() and u1.shape == (500, 16) and i1.shape == (6400, 16)


def test_held_out_items_are_fresh_and_distinct():
    train, cluster = synth.clustered_interactions(2000, 6400, 40000, 9)
    test = synth.held_out(train.tocsr(), cluster, 700, 10, 5)
    lengths = np.diff(test.indptr)
    assert (lengths > 0).sum() == 700 and set(lengths[lengths > 0]) == {10}
    assert test.multiply(train.tocsr()).nnz == 0
    assert test.nnz == 7000 and test.sum() == 7000  # no duplicate (user, item)
