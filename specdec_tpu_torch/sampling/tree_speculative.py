"""Tree speculative decoding over a static topology
(counterpart of ``specdec_tpu/sampling/tree_speculative.py``).

A chain verifies one candidate continuation per target forward; a tree
verifies a whole tree of candidates in the same single forward, so a window
where the drafter's top-1 is wrong but its top-2 is right still advances.

- The topology is a branching tuple, e.g. (2, 2, 2): every node of level l
  gets branching[l] children (``TreeTopology``).
- Tree attention is the ancestor mask of ``core.model.forward_step_tree``:
  a node attends to the prefix and its ancestors, at rope position
  prefix + depth, whatever its storage slot.
- The accepted root-to-leaf path is compacted into contiguous cache slots
  (``core.cache.compact_path``), in both models' caches: no recompute.

Two acceptance regimes, chosen by the logits processor:

- greedy (``GreedyProcessor`` or None): children are the drafter's top-k in
  ``lax.top_k`` order (``stable_top_k``); a child is accepted iff its token
  is the target's argmax at its parent, and the bonus token is the target's
  argmax at the last accepted node, so the output is greedy AR's tokens for
  any drafter and topology;
- sampled (any other processor): SpecInfer multi-draft rejection
  (``_sampled_tree_accept``); children are drawn IID from the drafter's
  processed distribution, and the output is distributed as target AR
  sampling.

The window runs eagerly on the device with one host read per window (the
accept count, the advance and the EOS flag), as ``sampling/speculative.py``
does. The cache capacity is S = P + gen_len + N + 2, so neither the tree
rows nor the compaction ever leave the cache.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import compact_path, init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.model import forward_step, forward_step_tree
from specdec_tpu_torch.sampling.processors import GreedyProcessor
from specdec_tpu_torch.sampling.speculative import commit_step
from specdec_tpu_torch.sampling.utils import (
    max_fn, normalize_eos, pad_to_bucket, stable_top_k,
)


class TreeTopology:
    """Static node bookkeeping for a branching tuple.

    Node 0 is the root (depth 0, the last committed token); level l
    (1..depth) holds prod(branching[:l]) nodes, numbered level by level.
    ``parent``, ``depths`` and ``ancestor`` (ancestor-or-self, [N, N]) are
    numpy arrays; ``on(device)`` gives ``depths`` and ``ancestor`` as
    tensors on a device, made once per device."""

    def __init__(self, branching: Tuple[int, ...]):
        assert branching and all(b >= 1 for b in branching)
        self.branching = tuple(int(b) for b in branching)
        self.depth = len(self.branching)
        sizes = [1]
        for b in self.branching:
            sizes.append(sizes[-1] * b)
        self.level_sizes = sizes                      # [1, n1, ..., nd]
        self.level_start = np.cumsum([0] + sizes).tolist()
        self.num_nodes = int(np.sum(sizes))

        parent = np.zeros((self.num_nodes,), np.int32)
        depth = np.zeros((self.num_nodes,), np.int32)
        for l in range(1, self.depth + 1):
            b = self.branching[l - 1]
            ps, cs = self.level_start[l - 1], self.level_start[l]
            for i in range(sizes[l]):
                parent[cs + i] = ps + i // b
                depth[cs + i] = l
        self.parent = parent
        self.depths = depth
        anc = np.zeros((self.num_nodes, self.num_nodes), bool)
        for i in range(self.num_nodes):
            j = i
            anc[i, i] = True
            while j != 0:
                j = int(parent[j])
                anc[i, j] = True
        self.ancestor = anc
        self._on: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def level_nodes(self, l: int) -> slice:
        return slice(self.level_start[l], self.level_start[l + 1])

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(depths int32 [N], ancestor bool [N, N]) on ``device``."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = (
                torch.from_numpy(self.depths).to(device),
                torch.from_numpy(self.ancestor).to(device))
        return self._on[device]


_TOPO_CACHE: Dict[Tuple[int, ...], TreeTopology] = {}


def _topology(branching: Sequence[int]) -> TreeTopology:
    """One ``TreeTopology`` per branching tuple (its device tensors are
    made once)."""
    branching = tuple(int(b) for b in branching)
    if branching not in _TOPO_CACHE:
        _TOPO_CACHE[branching] = TreeTopology(branching)
    return _TOPO_CACHE[branching]


def _children(topo: TreeTopology, l: int, cur: torch.Tensor) -> torch.Tensor:
    """[R, b] node indices of the children of ``cur`` [R] (a level-l node)
    at level l+1, clamped into the tree: where ``cur`` is not on level l
    (a walk that has stopped) they are don't-care indices, never used."""
    b = topo.branching[l]
    first = topo.level_start[l + 1] + (cur - topo.level_start[l]) * b
    idx = first[:, None] + torch.arange(b, device=cur.device)[None, :]
    return idx.clamp(0, topo.num_nodes - 1)


def _greedy_tree_accept(topo: TreeTopology, tree_toks: torch.Tensor,
                        targmax: torch.Tensor):
    """Greedy path walk over R trees at once: a child is accepted iff its
    token equals the target's argmax at its parent (top-k children are
    distinct, so at most one matches). tree_toks, targmax: [R, N] int64.
    Returns (chain [R, d] node indices, n_acc [R], next_tok [R]); chain
    entries past n_acc repeat the last accepted node."""
    R = tree_toks.shape[0]
    dev = tree_toks.device
    cur = torch.zeros((R,), dtype=torch.int64, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((R,), dtype=torch.int64, device=dev)
    chain = []
    for l in range(topo.depth):
        idx = _children(topo, l, cur)                             # [R, b]
        match = tree_toks.gather(1, idx) == targmax.gather(1, cur[:, None])
        nxt = idx.gather(1, torch.argmax(match.to(torch.int32), dim=1,
                                         keepdim=True))[:, 0]
        alive = alive & match.any(dim=1)
        cur = torch.where(alive, nxt, cur)
        chain.append(cur)
        n_acc = n_acc + alive.to(torch.int64)
    return (torch.stack(chain, dim=1), n_acc,
            targmax.gather(1, cur[:, None])[:, 0])


def _sampled_tree_accept(topo: TreeTopology, tree_toks: torch.Tensor,
                         q_nodes: torch.Tensor, p_nodes: torch.Tensor,
                         processor, generator: Optional[torch.Generator]):
    """SpecInfer multi-draft rejection walk over R trees at once (shared by
    the model-drafter and EAGLE tree loops).

    q_nodes[r, i]: the drafter's processed distribution at node i (node
    i's children were drawn IID from it); p_nodes[r, i]: the target's.
    The walk examines a node's children in order and accepts child x with
    probability min(1, r(x) / q(x)); each rejection updates the residual
    r <- norm(max(r - q, 0)), keeping r where that has no mass (the f32
    1e-38 division guard and 1e-12 mass test of the JAX walk). On full
    acceptance next_tok ~ p at the leaf, else ~ the final residual.
    tree_toks [R, N]; q_nodes, p_nodes [R, N, V] f32. Returns (chain
    [R, d], n_acc [R], next_tok [R])."""
    R = tree_toks.shape[0]
    dev = tree_toks.device
    rows = torch.arange(R, device=dev)
    cur = torch.zeros((R,), dtype=torch.int64, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((R,), dtype=torch.int64, device=dev)
    r = p_nodes[:, 0]
    died = torch.zeros_like(r)
    # one uniform per examined child, drawn in one call
    u_all = torch.rand((R, sum(topo.branching)), generator=generator,
                       device=dev)
    uidx = 0
    chain = []
    for l in range(topo.depth):
        idx = _children(topo, l, cur)
        q_cur = q_nodes[rows, cur]                                # [R, V]
        accepted = torch.zeros((R,), dtype=torch.bool, device=dev)
        for j in range(topo.branching[l]):
            ci = idx[:, j]
            x = tree_toks[rows, ci]
            examined = alive & ~accepted
            ratio = r[rows, x] / torch.clamp_min(q_cur[rows, x], 1e-38)
            acc_j = examined & (u_all[:, uidx] <= ratio)
            uidx += 1
            cur = torch.where(acc_j, ci, cur)
            res = max_fn(r - q_cur)
            mass = res.sum(dim=-1, keepdim=True)
            res = torch.where(mass > 1e-12,
                              res / torch.clamp_min(mass, 1e-38), r)
            r = torch.where((examined & ~acc_j)[:, None], res, r)
            accepted = accepted | acc_j
        died = torch.where((alive & ~accepted)[:, None], r, died)
        alive = alive & accepted
        chain.append(cur)
        n_acc = n_acc + alive.to(torch.int64)
        r = torch.where(alive[:, None], p_nodes[rows, cur], r)
    final = torch.where(alive[:, None], p_nodes[rows, cur], died)
    return (torch.stack(chain, dim=1), n_acc,
            processor.sample(final, generator))


def expand_children(topo: TreeTopology, l: int, logits: torch.Tensor,
                    tree_toks: torch.Tensor, q_nodes, processor, generator):
    """Fill level l+1 of ``tree_toks`` [N] from the drafter's logits
    [n_l, V] at level l's nodes: the top-b tokens in ``lax.top_k`` order
    (greedy, ``processor`` None), or b IID draws from each node's processed
    distribution, which is stored in ``q_nodes`` [N, V] (sampled)."""
    b = topo.branching[l]
    cs = topo.level_nodes(l + 1)
    if processor is None:
        tree_toks[cs] = stable_top_k(logits, b)[1].reshape(-1)
        return
    q_l = processor(logits)                                       # [n_l, V]
    q_nodes[topo.level_nodes(l)] = q_l
    tree_toks[cs] = processor.sample(
        q_l[:, None, :].expand(-1, b, -1), generator).reshape(-1)


def tree_accept(topo: TreeTopology, tree_toks: torch.Tensor,
                t_logits: torch.Tensor, q_nodes, processor, generator):
    """The window's path acceptance from the target's logits [N, V] over
    the tree: (chain [d], n_acc [1], next_tok [1])."""
    if processor is None:
        targmax = torch.argmax(t_logits, dim=-1)
        chain, n_acc, nxt = _greedy_tree_accept(topo, tree_toks[None],
                                                targmax[None])
    else:
        chain, n_acc, nxt = _sampled_tree_accept(
            topo, tree_toks[None], q_nodes[None], processor(t_logits)[None],
            processor, generator)
    return chain[0], n_acc, nxt


def _tree_spec_generate(
    inputs: Sequence[int],
    drafter_cfg: ModelConfig, drafter_params,
    target_cfg: ModelConfig, target_params,
    topo: TreeTopology, gen_len: int,
    eos_ids: Tuple[int, ...],
    processor,                           # None: greedy
    generator: Optional[torch.Generator],
    pad_token_id: int,
    device: torch.device,
) -> Tuple[List[int], int, int, int]:
    """Returns (generated tokens, accepted depth, speculated depth,
    windows)."""
    prompt, n = pad_to_bucket(inputs, pad_token_id)
    if n < 2:
        raise ValueError("tree speculation needs a prompt of >= 2 tokens")
    prompt = prompt.to(device)
    d, N = topo.depth, topo.num_nodes
    P = prompt.shape[0]
    S = P + gen_len + N + 2
    V = target_cfg.vocab_size
    depths, anc = topo.on(device)

    def lengths(v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=device)

    d_cache = init_cache(drafter_cfg, 1, S, device=device)
    t_cache = init_cache(target_cfg, 1, S, device=device)
    buf = torch.zeros((S,), dtype=torch.int64, device=device)
    buf[:P] = prompt
    total_len = min(drafter_cfg.max_position_embeddings,
                    target_cfg.max_position_embeddings, n + gen_len)

    # prefill both models over the prompt minus its last token, which is
    # the first window's root: the root's verify logits give token 1
    _, t_cache = forward_step(target_cfg, target_params, prompt[None, :],
                              t_cache)
    _, d_cache = forward_step(drafter_cfg, drafter_params, prompt[None, :],
                              d_cache)
    d_cache = d_cache.with_length(lengths(n - 1))
    t_cache = t_cache.with_length(lengths(n - 1))

    pos, finished, window = n, n >= total_len, 0
    accepted = speculated = 0
    while not finished and pos < total_len and window < gen_len + 1:
        start = pos - 1                     # slot of tree node 0, both models
        start_t = lengths(start)
        tree_toks = torch.zeros((N,), dtype=torch.int64, device=device)
        tree_toks[0] = buf[pos - 1]
        q_nodes = (None if processor is None else
                   torch.zeros((N, V), dtype=torch.float32, device=device))

        # --- drafter expansion, level by level -------------------------
        d_cache_l = d_cache
        for l in range(d):
            ls = topo.level_nodes(l)
            logits_l, d_cache_l = forward_step_tree(
                drafter_cfg, drafter_params, tree_toks[ls][None, :],
                d_cache_l, depths[ls], anc[ls, :topo.level_start[l + 1]],
                tree_start=start_t)
            expand_children(topo, l, logits_l[0], tree_toks, q_nodes,
                            processor, generator)
        # the last level too, so that the drafter's cache mirrors the
        # target's tree rows (compaction then applies to both); its logits
        # are not needed, so its lm_head is skipped
        ls = topo.level_nodes(d)
        _, d_cache_l = forward_step_tree(
            drafter_cfg, drafter_params, tree_toks[ls][None, :], d_cache_l,
            depths[ls], anc[ls, :N], tree_start=start_t, head=False)

        # --- target verify: the whole tree in one forward ---------------
        t_logits, t_cache_l = forward_step_tree(
            target_cfg, target_params, tree_toks[None, :], t_cache, depths,
            anc)
        chain, n_acc, bonus = tree_accept(topo, tree_toks, t_logits[0],
                                          q_nodes, processor, generator)

        # --- commit the accepted chain, then the bonus token -------------
        cand, advance, any_eos = commit_step(tree_toks[chain][None], n_acc,
                                             bonus, total_len - pos, eos_ids)
        buf[pos:pos + d + 1] = cand[0]
        # compact the accepted path: the chain node at depth j moves to
        # slot start + j (the root stays); the lengths follow the host read
        idx = start + chain
        d_cache = compact_path(d_cache_l, idx, start + 1, d_cache_l.length)
        t_cache = compact_path(t_cache_l, idx, start + 1, t_cache_l.length)
        n_h, advance_h, eos_h = torch.stack(
            [n_acc[0], advance[0], any_eos[0].to(n_acc.dtype)]).tolist()
        new_pos = pos + advance_h
        d_cache = d_cache.with_length(lengths(new_pos - 1))
        t_cache = t_cache.with_length(lengths(new_pos - 1))

        corrected = min(max(total_len - pos - 1, 0), d)
        accepted += min(n_h, corrected)
        speculated += corrected
        pos = new_pos
        finished = bool(eos_h) or pos >= total_len
        window += 1
    return buf[n:pos].tolist(), accepted, speculated, window


def sampled_processor(logits_processor):
    """None for greedy (``GreedyProcessor`` or None), else the processor:
    the tree loops' choice of acceptance regime."""
    if logits_processor is None or isinstance(logits_processor,
                                              GreedyProcessor):
        return None
    return logits_processor


def tree_speculative_generate(
    inputs: Sequence[int],
    drafter_cfg: ModelConfig, drafter_params,
    target_cfg: ModelConfig, target_params,
    branching: Tuple[int, ...] = (2, 2, 1, 1),
    max_gen_len: int = 40,
    logits_processor=None,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device=None,
) -> Tuple[List[int], float]:
    """Tree speculation. Returns (generated ids, chain-depth acceptance
    rate = accepted depth / max depth per window). ``GreedyProcessor`` or
    None: greedy (the output is greedy AR's tokens for any drafter and
    topology); any sampling processor: SpecInfer multi-draft rejection,
    drawing from ``generator`` (or a new one seeded with ``seed``).
    ``device=None`` means the card."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    tokens, acc, spec, _ = _tree_spec_generate(
        inputs, drafter_cfg, drafter_params, target_cfg, target_params,
        _topology(branching), int(max_gen_len), normalize_eos(eos_tokens_id),
        sampled_processor(logits_processor), generator, pad_token_id, device)
    return tokens, acc / spec if spec > 0 else 0.0
