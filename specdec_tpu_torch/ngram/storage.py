"""Adaptive n-gram stores used as model-free drafters (NASD)
(counterpart of ``specdec_tpu/ngram/storage.py``, copied line for line).

- ``OneLevelNGramStorage``: exact (n-1)-gram context -> argmax-count next
  token;
- ``NGramStorage``: multi-order backoff: try context orders n-1 ... 2,
  first hit wins; an unknown context returns a uniformly random token with
  known=False.

Pure Python on the host: the store is pointer-chasing dict logic. Unknown
contexts draw from ``random.Random(seed)``, the same generator as the JAX
package's store, so the two stores give the same predictions on the same
stream, unknown-context tokens included. ``ngram/native.py`` is the same
store in C++.
"""
from __future__ import annotations

import abc
import random
from typing import Dict, List, Sequence, Tuple


class INgramStorage(abc.ABC):
    """Interface: predict/update/seed an adaptive n-gram model
    (ref: ngram_assisted/ngram_storage.py:5-69)."""

    def __init__(self, n: int, vocab_size: int):
        assert n > 1, "n should be greater than 1"
        self.n = n
        self.vocab_size = vocab_size

    @abc.abstractmethod
    def next_token(self, context: Sequence[int]) -> Tuple[int, bool]:
        """Most likely next token for this context; (token, known)."""

    @abc.abstractmethod
    def has_gram(self, ngram: Sequence[int]) -> bool: ...

    @abc.abstractmethod
    def update(self, context: Sequence[int], next_tokens: Sequence[int]): ...

    @abc.abstractmethod
    def initialize(self, token_ids: Sequence[int]): ...

    @abc.abstractmethod
    def reset(self): ...


class OneLevelNGramStorage(INgramStorage):
    """Exact-order store: only (n-1)-gram contexts (ref :73-151)."""

    def __init__(self, n: int, vocab_size: int, seed: int = 0):
        super().__init__(n, vocab_size)
        self._rng = random.Random(seed)
        self.counts: Dict[tuple, Dict[int, int]] = {}
        self.best: Dict[tuple, int] = {}

    def next_token(self, context: Sequence[int]) -> Tuple[int, bool]:
        if len(context) >= self.n - 1:
            gram = tuple(int(t) for t in context[-(self.n - 1):])
            if gram in self.best:
                return self.best[gram], True
        return self._rng.randrange(self.vocab_size), False

    def has_gram(self, ngram: Sequence[int]) -> bool:
        if len(ngram) < self.n:
            return False
        gram = tuple(int(t) for t in ngram[-(self.n):-1])
        return gram in self.counts and int(ngram[-1]) in self.counts[gram]

    def _bump(self, gram: tuple, token: int):
        slot = self.counts.setdefault(gram, {})
        if gram not in self.best:
            self.best[gram] = token
        slot[token] = slot.get(token, 0) + 1
        if slot[token] > slot[self.best[gram]]:
            self.best[gram] = token

    def update(self, context: Sequence[int], next_tokens: Sequence[int]):
        if len(context) < self.n - 1:
            return
        gram = tuple(int(t) for t in context[-(self.n - 1):])
        for token in next_tokens:
            self._bump(gram, int(token))

    def initialize(self, token_ids: Sequence[int]):
        ids = [int(t) for t in token_ids]
        for i in range(len(ids) - self.n + 1):
            self._bump(tuple(ids[i:i + self.n - 1]), ids[i + self.n - 1])

    def reset(self):
        self.counts.clear()
        self.best.clear()


class NGramStorage(INgramStorage):
    """Backoff store over orders n-1 … 2 (ref :154-249)."""

    def __init__(self, n: int, vocab_size: int, seed: int = 0):
        super().__init__(n, vocab_size)
        self._rng = random.Random(seed)
        # order j → {gram(tuple of j) → {token → count}} / best token
        self.counts: Dict[int, Dict[tuple, Dict[int, int]]] = {}
        self.best: Dict[int, Dict[tuple, int]] = {}

    def next_token(self, context: Sequence[int]) -> Tuple[int, bool]:
        ctx = [int(t) for t in context]
        for j in range(min(self.n - 1, len(ctx)), 1, -1):
            gram = tuple(ctx[-j:])
            hit = self.best.get(j, {}).get(gram)
            if hit is not None:
                return hit, True
        return self._rng.randrange(self.vocab_size), False

    def has_gram(self, ngram: Sequence[int]) -> bool:
        ids = [int(t) for t in ngram]
        if not ids:
            return False
        for j in range(min(self.n - 1, len(ids) - 1), 1, -1):
            gram = tuple(ids[-(j + 1):-1])
            if ids[-1] in self.counts.get(j, {}).get(gram, {}):
                return True
        return False

    def _bump(self, j: int, gram: tuple, token: int):
        slot = self.counts.setdefault(j, {}).setdefault(gram, {})
        best_j = self.best.setdefault(j, {})
        if gram not in best_j:
            best_j[gram] = token
        slot[token] = slot.get(token, 0) + 1
        if slot[token] > slot[best_j[gram]]:
            best_j[gram] = token

    def update(self, context: Sequence[int], next_tokens: Sequence[int]):
        ctx = [int(t) for t in context]
        if not ctx:
            return
        for j in range(min(self.n - 1, len(ctx)), 1, -1):
            gram = tuple(ctx[-j:])
            for token in next_tokens:
                self._bump(j, gram, int(token))

    def initialize(self, token_ids: Sequence[int]):
        ids = [int(t) for t in token_ids]
        for i in range(len(ids)):
            for j in range(min(self.n - 1, i), 1, -1):
                self._bump(j, tuple(ids[i - j:i]), ids[i])

    def reset(self):
        self.counts.clear()
        self.best.clear()
