"""EAGLE tree speculative decoding over a static topology
(counterpart of ``specdec_tpu/sampling/eagle_tree.py``).

The EAGLE drafter (``core/eagle.py``) expands a static candidate tree, each
node of level l proposing its top ``branching[l]`` next tokens, and the
target verifies the whole tree in one ancestor-masked forward
(``core.model.forward_step_tree_features``): tree verification
(``sampling/tree_speculative.py``) with EAGLE drafting
(``sampling/eagle_speculative.py``).

A window:

- the EAGLE catch-up rewrite of the chain loop over depth + 2 pairs ending
  at pair pos - 2: its last output is the root's, whose logits rank the
  root's children (level 1) and whose f_hat is the root's predicted
  feature;
- levels 1 .. depth-1: one ``eagle_forward_tree`` a level, node j's pair
  being (token j, f_hat of its parent); the last level has no children, so
  it is never forwarded; the EAGLE cache needs no compaction, because the
  next window's catch-up re-derives it;
- the target verifies the root and every node with features; acceptance
  is ``tree_speculative``'s (greedy: the output is greedy AR's tokens for
  any drafter and topology; a sampling processor: SpecInfer multi-draft
  rejection); the accepted path's features go to ``fbuf`` and the target
  cache is compacted.

One host read per window, as in the other loops.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.core.cache import compact_path, init_cache
from specdec_tpu_torch.core.config import ModelConfig
from specdec_tpu_torch.core.eagle import eagle_forward_tree
from specdec_tpu_torch.core.model import (
    forward_step_features, forward_step_tree_features,
)
from specdec_tpu_torch.sampling.eagle_speculative import catch_up
from specdec_tpu_torch.sampling.speculative import commit_step
from specdec_tpu_torch.sampling.tree_speculative import (
    TreeTopology, _topology, expand_children, sampled_processor, tree_accept,
)
from specdec_tpu_torch.sampling.utils import normalize_eos, pad_to_bucket


def _eagle_tree_generate(
    inputs: Sequence[int],
    eagle_cfg: ModelConfig, eagle_params,
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
        raise ValueError("eagle tree speculation needs a prompt of >= 2 "
                         "tokens (the catch-up block ends at pair pos-2)")
    prompt = prompt.to(device)
    d, N = topo.depth, topo.num_nodes
    V, D = target_cfg.vocab_size, target_cfg.hidden_size
    P = prompt.shape[0]
    S = P + gen_len + N + 2
    C = d + 2              # catch-up pairs: max commits per window d+1, +1
    depths, anc = topo.on(device)
    parents = [torch.from_numpy(topo.parent[topo.level_nodes(l)]).to(device)
               for l in range(d)]

    def lengths(v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=device)

    e_cache = init_cache(eagle_cfg, 1, S, device=device)
    t_cache = init_cache(target_cfg, 1, S, device=device)
    buf = torch.zeros((S,), dtype=torch.int64, device=device)
    buf[:P] = prompt
    fbuf = torch.zeros((S, D), dtype=target_cfg.dtype, device=device)
    total_len = min(eagle_cfg.max_position_embeddings,
                    target_cfg.max_position_embeddings, n + gen_len)

    # the target prefill seeds fbuf; window 0's root is the prompt's last
    # token, whose verify logits give token 1
    _, t_feats, t_cache = forward_step_features(
        target_cfg, target_params, prompt[None, :], t_cache)
    fbuf[:P] = t_feats[0].to(fbuf.dtype)
    t_cache = t_cache.with_length(lengths(n - 1))

    pos, finished, window = n, n >= total_len, 0
    accepted = speculated = 0
    while not finished and pos < total_len and window < gen_len + 1:
        # --- catch-up: the root's logits and predicted feature ------------
        root_logits, f_root, e_cache = catch_up(
            eagle_cfg, eagle_params, target_params, buf, fbuf, e_cache, pos,
            C)
        tree_toks = torch.zeros((N,), dtype=torch.int64, device=device)
        tree_toks[0] = buf[pos - 1]
        q_nodes = (None if processor is None else
                   torch.zeros((N, V), dtype=torch.float32, device=device))
        tree_fhat = torch.zeros((N, D), dtype=fbuf.dtype, device=device)
        tree_fhat[0] = f_root.to(fbuf.dtype)
        expand_children(topo, 0, root_logits[None], tree_toks, q_nodes,
                        processor, generator)

        # --- levels 1..d-1: one drafter tree forward each; EAGLE node j is
        # target node j+1 (the root's pair ends the catch-up prefix) -------
        e_start = lengths(pos - 1)
        for l in range(1, d):
            ls = topo.level_nodes(l)
            logits_l, fhat_l, e_cache = eagle_forward_tree(
                eagle_cfg, eagle_params, target_params,
                tree_toks[ls][None, :], tree_fhat[parents[l]][None], e_cache,
                depths[ls] - 1, anc[ls, 1:topo.level_start[l + 1]],
                tree_start=e_start)
            tree_fhat[ls] = fhat_l[0].to(fbuf.dtype)
            expand_children(topo, l, logits_l[0], tree_toks, q_nodes,
                            processor, generator)

        # --- target verify: the whole tree, with features -----------------
        t_logits, t_feats, t_cache_l = forward_step_tree_features(
            target_cfg, target_params, tree_toks[None, :], t_cache, depths,
            anc)
        chain, n_acc, bonus = tree_accept(topo, tree_toks, t_logits[0],
                                          q_nodes, processor, generator)

        # --- commit the tokens ----------------------------------------------
        cand, advance, any_eos = commit_step(tree_toks[chain][None], n_acc,
                                             bonus, total_len - pos, eos_ids)
        buf[pos:pos + d + 1] = cand[0]
        # the verify features along the root and the chain land at positions
        # pos-1 .. pos-1+d; those past n_acc lie past the next window's reads
        path = torch.cat([chain.new_zeros((1,)), chain])
        fbuf[pos - 1:pos + d] = t_feats[0][path].to(fbuf.dtype)
        # the accepted path compacted in the target cache only
        t_cache = compact_path(t_cache_l, (pos - 1) + chain, pos,
                               t_cache_l.length)
        n_h, advance_h, eos_h = torch.stack(
            [n_acc[0], advance[0], any_eos[0].to(n_acc.dtype)]).tolist()

        corrected = min(max(total_len - pos - 1, 0), d)
        accepted += min(n_h, corrected)
        speculated += corrected
        pos += advance_h
        finished = bool(eos_h) or pos >= total_len
        t_cache = t_cache.with_length(lengths(pos - 1))
        window += 1
    return buf[n:pos].tolist(), accepted, speculated, window


def eagle_tree_generate(
    inputs: Sequence[int],
    eagle_cfg: ModelConfig, eagle_params,
    target_cfg: ModelConfig, target_params,
    branching: Tuple[int, ...] = (3, 2, 1),
    max_gen_len: int = 40,
    logits_processor=None,
    eos_tokens_id=1,
    pad_token_id: int = 0,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device=None,
) -> Tuple[List[int], float]:
    """EAGLE tree speculation. Returns (generated ids, chain-depth
    acceptance rate). ``GreedyProcessor`` or None: greedy (the output is
    greedy AR's tokens for any drafter and topology); any sampling
    processor: SpecInfer multi-draft rejection, drawing from ``generator``
    (or a new one seeded with ``seed``). ``device=None`` means the
    card."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    tokens, acc, spec, _ = _eagle_tree_generate(
        inputs, eagle_cfg, eagle_params, target_cfg, target_params,
        _topology(branching), int(max_gen_len), normalize_eos(eos_tokens_id),
        sampled_processor(logits_processor), generator, pad_token_id, device)
    return tokens, acc / spec if spec > 0 else 0.0
