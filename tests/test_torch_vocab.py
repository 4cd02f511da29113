"""Vocabulary-tree retrieval (ops/vocab.py) against sfm_tpu/ops/vocab.py.

Tolerances:
- k-means: one step, and three, from the same initial centers (sfm_tpu's
  seeding draws fed to the port): 1e-5; the port's batched nodes equal its
  one-node calls, and its slicing of the node axis changes nothing (exact);
- given sfm_tpu's tree centers: word ids exact (tie-free fixture: unit
  descriptors near a few well separated words), BoW vectors 1e-6, the
  neighbour lists exact;
- spread_ranks: exact;
- vocab_tree_pairs (the port's own tree, k-means seeded by its keyed
  torch.Generator): same-cluster retrieval and pruning as
  tests/unit/test_vocab.py asks of sfm_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import VocabConfig as JVocabConfig
from sfm_tpu.ops import vocab as jvocab
from sfm_tpu_torch.config import VocabConfig
from sfm_tpu_torch.ops import vocab
from sfm_tpu_torch.pipeline.stages import FeatureSet

torch.set_num_threads(2)


def clustered_descriptors(num_images=12, n_per=64, num_clusters=3, seed=0):
    """tests/unit/test_vocab.py's fixture: images fall in appearance
    clusters; same-cluster images share words."""
    rng = np.random.default_rng(seed)
    cluster_words = rng.normal(size=(num_clusters, 32, 128)).astype(np.float32)
    cluster_words /= np.linalg.norm(cluster_words, axis=-1, keepdims=True)
    desc = np.zeros((num_images, n_per, 128), np.float32)
    labels = []
    for i in range(num_images):
        c = i % num_clusters
        labels.append(c)
        picks = rng.integers(0, 32, n_per)
        d = cluster_words[c, picks] + 0.03 * rng.normal(size=(n_per, 128)).astype(np.float32)
        desc[i] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return desc, np.asarray(labels)


def _feats(desc, valid=None):
    B, N, _ = desc.shape
    return FeatureSet(xy=np.zeros((B, N, 2), np.float32), sigma=np.ones((B, N), np.float32),
                      angle=np.zeros((B, N), np.float32), response=np.ones((B, N), np.float32),
                      desc=desc, valid=np.ones((B, N), bool) if valid is None else valid)


@pytest.mark.parametrize("iters", [1, 3])
def test_kmeans_from_the_same_initial_centers(iters):
    desc, _ = clustered_descriptors()
    data = desc.reshape(-1, 128)[:500]
    w = (np.arange(500) < 470).astype(np.float32)          # 30 padding rows
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jvocab._kmeans(key, jnp.asarray(data), jnp.asarray(w), 8, iters))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (500,))))      # sfm_tpu's seeding draws
    ours = vocab._kmeans(u[None], torch.from_numpy(data)[None], torch.from_numpy(w)[None], 8, iters)[0]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_kmeans_nodes_batch_like_single_calls():
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.normal(size=(3, 200, 16)).astype(np.float32))
    data = data / data.norm(dim=-1, keepdim=True)
    w = torch.from_numpy((rng.uniform(size=(3, 200)) > 0.2).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(3, 200)).astype(np.float32))
    batched = vocab._kmeans(u, data, w, 4, 5)
    for g in range(3):
        torch.testing.assert_close(batched[g], vocab._kmeans(u[g:g + 1], data[g:g + 1], w[g:g + 1], 4, 5)[0],
                                   rtol=0, atol=0)


def test_tree_build_is_keyed_and_slicing_free(monkeypatch):
    desc, _ = clustered_descriptors()
    flat = torch.from_numpy(desc.reshape(-1, 128))
    cfg = VocabConfig(branching=4, depth=3, kmeans_iters=5)
    a = vocab.build_vocab_tree(0, flat, cfg)
    monkeypatch.setattr(vocab, "_GROUP_BYTES", 1)          # one node per k-means batch
    monkeypatch.setattr(vocab, "_REASSIGN_CHUNK", 100)
    b = vocab.build_vocab_tree(0, flat, cfg)
    for ca, cb in zip(a.centers, b.centers):
        torch.testing.assert_close(ca, cb, rtol=0, atol=0)
    assert torch.equal(a.train_words, b.train_words)
    assert torch.equal(a.train_words, a.quantize(flat))     # the build's words are the descent's
    c = vocab.build_vocab_tree(1, flat, cfg)
    assert not torch.equal(a.centers[0], c.centers[0])


@pytest.fixture(scope="module")
def jax_tree():
    desc, _ = clustered_descriptors()
    cfg = JVocabConfig(branching=4, depth=2, kmeans_iters=5)
    tree = jvocab.build_vocab_tree(jax.random.PRNGKey(0), jnp.asarray(desc.reshape(-1, 128)), cfg)
    ours = vocab.VocabTree([torch.from_numpy(np.array(c)) for c in tree.centers], 4, 2)
    return desc, tree, ours


def test_quantize_bow_and_neighbors_given_sfm_tpu_centers(jax_tree):
    desc, tree, ours = jax_tree
    B, N, D = desc.shape
    flat = desc.reshape(-1, D)
    w_j = np.asarray(tree.quantize(jnp.asarray(flat)))
    w_t = ours.quantize(torch.from_numpy(flat)).numpy()
    np.testing.assert_array_equal(w_t, w_j)
    assert len(np.unique(w_j)) > 4
    valid = np.random.default_rng(1).uniform(size=(B, N)) > 0.1
    bow_j = np.array(jvocab.bow_vectors(tree, jnp.asarray(desc), jnp.asarray(valid)))
    bow_t = vocab.bow_vectors(ours, torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(bow_t, bow_j, rtol=0, atol=1e-6)
    for k in (3, 7):
        np.testing.assert_array_equal(vocab._topk_neighbors(torch.from_numpy(bow_j), k).numpy(),
                                      np.asarray(jvocab._topk_neighbors(jnp.asarray(bow_j), k)))


def test_spread_ranks_equal_sfm_tpu():
    for k in (1, 4, 6, 12, 20):
        for n in (3, 5, 8, 100, 127, 9999):
            for scales in (0, 3, 8):
                assert vocab.spread_ranks(k, n, scales) == jvocab.spread_ranks(k, n, scales), (k, n, scales)


def test_retrieval_finds_same_cluster_images():
    desc, labels = clustered_descriptors()
    B = len(desc)
    cfg = VocabConfig(branching=4, depth=3, num_neighbors=3, kmeans_iters=5,
                      training_desc_per_image=64, retrieval_spread_scales=0)
    pairs = vocab.vocab_tree_pairs(_feats(desc), cfg, "cpu", seed=0)
    assert len(pairs) > 0 and pairs.dtype == np.int32 and (pairs[:, 0] < pairs[:, 1]).all()
    same = np.mean([labels[i] == labels[j] for i, j in pairs])
    assert same > 0.8, same
    assert len(pairs) < B * (B - 1) // 2
    # Stratified retrieval keeps the near picks in the cluster and adds reach.
    cfg_s = VocabConfig(branching=4, depth=3, num_neighbors=4, kmeans_iters=5, training_desc_per_image=64)
    cfg_0 = VocabConfig(branching=4, depth=3, num_neighbors=4, kmeans_iters=5, training_desc_per_image=64,
                        retrieval_spread_scales=0)
    pairs_s = vocab.vocab_tree_pairs(_feats(desc), cfg_s, "cpu", seed=0)
    pairs_0 = vocab.vocab_tree_pairs(_feats(desc), cfg_0, "cpu", seed=0)
    assert np.mean([labels[i] == labels[j] for i, j in pairs_s]) > 0.35
    assert sum(labels[i] != labels[j] for i, j in pairs_s) > sum(labels[i] != labels[j] for i, j in pairs_0)


def test_vocab_pairs_with_padding_slots():
    """Invalid keypoint slots (zero descriptors) weigh nothing in training
    or in the term frequencies."""
    desc, labels = clustered_descriptors(num_images=9, n_per=48)
    valid = np.ones(desc.shape[:2], bool)
    valid[:, 40:] = False
    desc[:, 40:] = 0.0
    cfg = VocabConfig(branching=4, depth=2, num_neighbors=2, kmeans_iters=5, training_desc_per_image=48,
                      retrieval_spread_scales=0)
    pairs = vocab.vocab_tree_pairs(_feats(desc, valid), cfg, "cpu", seed=3)
    assert np.mean([labels[i] == labels[j] for i, j in pairs]) > 0.8
