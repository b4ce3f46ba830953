"""The port's n-gram stores and device table against the JAX package's.

The host stores are pure Python with ``random.Random(seed)`` in both
packages, so on the same stream they agree exactly, unknown-context tokens
included; the native store agrees with the Python one (as
tests/test_ngram.py holds the JAX pair). The device tables are compared
bit for bit: the hash, every batched update (last writer wins, on a table
small enough that writes collide) and the prompt seeding; lookups give
JAX's (token, known) wherever known."""
import random

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from specdec_tpu.ngram import device_table as jdt
from specdec_tpu.ngram import storage as js

from specdec_tpu_torch.ngram import device_table as tdt
from specdec_tpu_torch.ngram import native as tnative
from specdec_tpu_torch.ngram import storage as ts

torch.set_num_threads(2)


def drive(store_a, store_b, seed, alphabet=5, steps=300):
    """The same random stream of initialize / update / next_token /
    has_gram / reset calls on both stores, over tokens from a small
    alphabet so that contexts recur; every answer must agree. Returns how
    many lookups hit a known context."""
    rng = random.Random(seed)
    seq = [rng.randrange(alphabet) for _ in range(120)]
    store_a.initialize(seq)
    store_b.initialize(seq)
    hits = 0
    for step in range(steps):
        ctx = [rng.randrange(alphabet) for _ in range(rng.randrange(0, 8))]
        op = rng.random()
        if op < 0.4:
            toks = [rng.randrange(alphabet)
                    for _ in range(rng.randrange(1, 4))]
            store_a.update(ctx, toks)
            store_b.update(ctx, toks)
        elif op < 0.8:
            a, b = store_a.next_token(ctx), store_b.next_token(ctx)
            assert a == b, (step, ctx, a, b)
            hits += a[1]
        elif op < 0.98:
            gram = ctx + [rng.randrange(alphabet)]
            assert store_a.has_gram(gram) == store_b.has_gram(gram), gram
        else:
            store_a.reset()
            store_b.reset()
            store_a.initialize(seq[:40])
            store_b.initialize(seq[:40])
    return hits


@pytest.mark.parametrize("name,n", [("NGramStorage", 3), ("NGramStorage", 4),
                                    ("OneLevelNGramStorage", 3)])
def test_python_stores_equal_jax(name, n):
    """Same answers on the same stream, the random tokens of unknown
    contexts included (both draw from random.Random(seed))."""
    hits = drive(getattr(ts, name)(n, 40, seed=5),
                 getattr(js, name)(n, 40, seed=5), seed=n)
    assert 20 < hits


def test_native_store_matches_python_store():
    """The port's C++ store agrees with its Python store on known contexts
    and has_gram after the same stream (tests/test_ngram.py's check), and
    builds into build/ngram/ at the root of the checkout."""
    rng = random.Random(0)
    py = ts.NGramStorage(n=4, vocab_size=40)
    nat = tnative.NativeNGramStorage(n=4, vocab_size=40)
    assert tnative._target().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "ngram")
    seed_seq = [rng.randrange(40) for _ in range(120)]
    py.initialize(seed_seq)
    nat.initialize(seed_seq)
    for _ in range(300):
        ctx = [rng.randrange(40) for _ in range(rng.randrange(1, 8))]
        toks = [rng.randrange(40) for _ in range(rng.randrange(1, 4))]
        py.update(ctx, toks)
        nat.update(ctx, toks)
    hits = 0
    for _ in range(500):
        ctx = [rng.randrange(40) for _ in range(rng.randrange(1, 8))]
        pt, pk = py.next_token(ctx)
        nt, nk = nat.next_token(ctx)
        assert pk == nk, ctx
        if pk:
            hits += 1
            assert pt == nt, ctx
        else:
            assert 0 <= nt < 40
        gram = ctx + [rng.randrange(40)]
        assert py.has_gram(gram) == nat.has_gram(gram), gram
    assert hits > 20 and nat.size() > 0
    py.reset()
    nat.reset()
    assert not py.next_token([1, 2, 3])[1]
    assert not nat.next_token([1, 2, 3])[1]


def test_native_store_raises_without_gxx(monkeypatch, tmp_path):
    """No g++: NativeUnavailable, never the Python store in its place."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "ngram")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(tnative.NativeUnavailable, match="g\\+\\+"):
        tnative.NativeNGramStorage(n=3, vocab_size=10)
    assert not tnative.native_available()


def random_contexts(rng, W, width, vocab, pad_share=0.2):
    """[W, width] int32 contexts, some with -1 padding at the front."""
    ctx = rng.integers(0, vocab, size=(W, width)).astype(np.int32)
    for w in np.flatnonzero(rng.random(W) < pad_share):
        ctx[w, :rng.integers(1, width + 1)] = -1
    return ctx


def test_bucket_equals_jax():
    """The int32 wrapping hash, computed modulo 2**32 in int64."""
    rng = np.random.default_rng(0)
    ctx = rng.integers(-1, 2 ** 31 - 1, size=(500, 4)).astype(np.int32)
    ctx[:50] = rng.integers(0, 64, size=(50, 4))
    got = tdt._bucket(torch.from_numpy(ctx), 1 << 16).numpy()
    ref = np.asarray(jax.jit(jax.vmap(lambda c: jdt._bucket(c, 1 << 16)))(
        jnp.asarray(ctx)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,capacity", [(3, 16), (4, 64), (3, 1 << 12)])
def test_table_update_and_seed_equal_jax(n, capacity):
    """Batched writes (the last writer of each bucket wins) and prompt
    seeding leave ctx/tok arrays equal to JAX's one-by-one updates, bit
    for bit; a capacity of 16 makes most writes collide."""
    rng = np.random.default_rng(capacity)
    V, W = 50, 60
    jt = jdt.init_device_table(n, capacity)
    pt = tdt.init_device_table(n, capacity, device="cpu")
    prompt = rng.integers(0, V, size=24).astype(np.int32)
    jt = jax.jit(jdt.table_seed)(jt, jnp.asarray(prompt), jnp.int32(19))
    tdt.table_seed(pt, torch.from_numpy(prompt), 19)

    @jax.jit
    def one_by_one(table, ctx, nxt, valid):
        def body(w, tbl):
            return jax.lax.cond(valid[w], lambda: jdt.table_update(
                tbl, ctx[w], nxt[w]), lambda: tbl)
        return jax.lax.fori_loop(0, ctx.shape[0], body, table)

    for _ in range(3):
        ctx = random_contexts(rng, W, n - 1, V)
        nxt = rng.integers(0, V, size=W).astype(np.int32)
        valid = rng.random(W) < 0.8
        jt = one_by_one(jt, jnp.asarray(ctx), jnp.asarray(nxt),
                        jnp.asarray(valid))
        tdt.table_update(pt, torch.from_numpy(ctx), torch.from_numpy(nxt),
                         torch.from_numpy(valid))
        for k in range(len(jt.ctx)):
            np.testing.assert_array_equal(pt.ctx[k].numpy(),
                                          np.asarray(jt.ctx[k]))
            np.testing.assert_array_equal(pt.tok[k].numpy(),
                                          np.asarray(jt.tok[k]))
    assert pt.orders == jt.orders and pt.capacity == capacity


def test_table_lookup_equals_jax_where_known():
    rng = np.random.default_rng(3)
    V, n = 40, 4
    jt = jdt.init_device_table(n, 256)
    pt = tdt.init_device_table(n, 256, device="cpu")
    stream = rng.integers(0, 8, size=200).astype(np.int32)   # repetitive
    jt = jax.jit(jdt.table_seed)(jt, jnp.asarray(stream), jnp.int32(200))
    tdt.table_seed(pt, torch.from_numpy(stream), 200)
    ctx = np.concatenate([random_contexts(rng, 150, n - 1, 8),
                          random_contexts(rng, 50, n - 1, V)])
    keys = jax.random.split(jax.random.key(0), len(ctx))
    jtok, jknown = jax.jit(jax.vmap(
        lambda c, k: jdt.table_lookup(jt, c, k, V)))(jnp.asarray(ctx), keys)
    tok, known = tdt.table_lookup(pt, torch.from_numpy(ctx),
                                  torch.Generator().manual_seed(0), V)
    jtok, jknown = np.asarray(jtok), np.asarray(jknown)
    np.testing.assert_array_equal(known.numpy(), jknown)
    np.testing.assert_array_equal(tok.numpy()[jknown], jtok[jknown])
    assert 20 < jknown.sum() < len(ctx)
    unknown = tok.numpy()[~jknown]
    assert unknown.min() >= 0 and unknown.max() < V


def test_single_writes_backoff_and_recency():
    """JAX's one-write form of ``table_update`` (tests/test_device_ngram.py's
    cases): a context known only at order 2 backs off to it, the higher
    order wins once present, a later write replaces an earlier one, and an
    unknown context draws a token in range."""
    table = tdt.init_device_table(3, 256, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def lookup(ctx):
        tok, known = tdt.table_lookup(table, torch.tensor(ctx), gen, 64)
        return int(tok), bool(known)

    tdt.table_update(table, torch.tensor([-1, 9]), torch.tensor(12))
    assert lookup([4, 9]) == (12, True)
    tdt.table_update(table, torch.tensor([4, 9]), torch.tensor(55))
    assert lookup([4, 9]) == (55, True)
    tdt.table_update(table, torch.tensor([4, 9]), torch.tensor(56))
    assert lookup([4, 9]) == (56, True)
    tok, known = lookup([7, 8])
    assert not known and 0 <= tok < 64
