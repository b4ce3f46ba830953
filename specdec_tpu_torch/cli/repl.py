"""Interactive comparison REPL (counterpart of ``specdec_tpu/cli/repl.py``):
``python -m specdec_tpu_torch.cli.repl``.

Side-by-side runs of speculative decoding, NASD, target AR and drafter AR
on the same prompt with throughput ratios, driven by the JAX REPL's
slash-commands: /speculative /target /drafter /ngram /gamma /length
/processor /cache /chat /debug /set_ngramstorage /top_k_filler
/reset_in_between /random /clear /quit, and ``auto <n>``, which runs n
random ShareGPT prompts back to back.

The models come from ``engine/model_loader.py::load_models``
(TARGET_MODEL and DRAFTER_MODEL, ``synthetic:llama-1b`` and
``synthetic:llama-70m`` by default) onto ``--device`` (the card by
default; without CUDA the REPL raises unless ``--device cpu`` is given).
Every run is seeded with the REPL's seed, so a command repeated gives the
same tokens.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from specdec_tpu_torch import resolve_device
from specdec_tpu_torch.engine.dataset import load_sharegpt_multi, random_prompt
from specdec_tpu_torch.engine.infer_engine import tokenize_batch
from specdec_tpu_torch.engine.model_loader import load_models
from specdec_tpu_torch.ngram import NGramStorage, OneLevelNGramStorage
from specdec_tpu_torch.ngram.assisted import ngram_assisted_speculative_generate
from specdec_tpu_torch.sampling.base_decoding import autoregressive_generate
from specdec_tpu_torch.sampling.processors import (
    GreedyProcessor, MultinomialProcessor, NucleusProcessor, TopKProcessor,
    TopKNucleusProcessor,
)
from specdec_tpu_torch.sampling.speculative import speculative_generate

PROCESSORS = {
    "greedy": {"cls": GreedyProcessor, "args": {"temperature": float}},
    "multinomial": {"cls": MultinomialProcessor, "args": {"temperature": float}},
    "topk": {"cls": TopKProcessor,
             "args": {"temperature": float, "top_k": int}},
    "nucleus": {"cls": NucleusProcessor,
                "args": {"temperature": float, "top_p": float}},
    "topknucleus": {"cls": TopKNucleusProcessor,
                    "args": {"temperature": float, "top_k": int,
                             "top_p": float}},
}


class InferenceCLI:
    def __init__(self, target_model: Optional[str] = None,
                 drafter_model: Optional[str] = None, device=None):
        print("Speculative Decoding Interactive CLI (PyTorch/CUDA)")
        self.device = resolve_device(device)
        self.gen_len = int(os.getenv("GENERATION_LENGTH", "60"))
        self.gamma = int(os.getenv("GAMMA_VALUE", "4"))
        self.debug = False
        self.spec = True
        self.dr = False
        self.target_gen = True
        self.ngram_gen = False
        self.chat = True
        self.cache = True  # informational toggle; slotted cache always on
        self.top_k_filler = 3
        self.reset_in_between = False
        self.processor = GreedyProcessor()
        self._seed = 42

        bundle = load_models(
            target_model or os.getenv("TARGET_MODEL", "synthetic:llama-1b"),
            drafter_model or os.getenv("DRAFTER_MODEL", "synthetic:llama-70m"),
            device=self.device)
        self.target_cfg = bundle["target"]["cfg"]
        self.target_params = bundle["target"]["params"]
        self.drafter_cfg = bundle["drafter"]["cfg"]
        self.drafter_params = bundle["drafter"]["params"]
        self.eagle_drafter = bool(bundle["drafter"].get("eagle"))
        self.tokenizer = bundle["tokenizer"]
        self.end_tokens = bundle["end_tokens"]
        self.pad_token_id = bundle["pad_token_id"]

        self.ngram_n = 3
        self.ngram = NGramStorage(n=self.ngram_n,
                                  vocab_size=self.target_cfg.vocab_size)
        self._load_sharegpt_data()

    def _load_sharegpt_data(self):
        sharegpt_dir = os.getenv("SHAREGPT_DIR", "sharegpt_gpt4")
        paths = [os.path.join(sharegpt_dir, f) for f in (
            "sharegpt_gpt4.jsonl", "sharegpt_V3_format.jsonl",
            "sharegpt_zh_38K_format.jsonl")]
        self.sharegpt_parts = load_sharegpt_multi(paths)

    def _get_random_prompt(self):
        return random_prompt(self.sharegpt_parts)

    # ------------------------------------------------------------------ infer
    def _infer(self, prompt: str):
        ids = tokenize_batch(self.tokenizer, [prompt], 2048,
                             chat=self.chat)[0]
        common = dict(logits_processor=self.processor,
                      max_gen_len=self.gen_len,
                      eos_tokens_id=self.end_tokens,
                      pad_token_id=self.pad_token_id, seed=self._seed,
                      device=self.device)
        results = {}

        if self.spec:
            t0 = time.time()
            if self.eagle_drafter:
                from specdec_tpu_torch.sampling.eagle_speculative import (
                    eagle_generate as spec_fn,
                )
            else:
                spec_fn = speculative_generate  # same signature by design
            out, rate = spec_fn(
                ids, self.drafter_cfg, self.drafter_params,
                self.target_cfg, self.target_params,
                tokenizer=self.tokenizer, gamma=self.gamma,
                debug=self.debug, **common)
            dt = time.time() - t0
            results["speculative"] = (out, dt)
            print(f"[speculative]  ({dt:.2f}s, accept {rate:.3f}) "
                  f"{self.tokenizer.decode(out)}")

        if self.ngram_gen:
            if self.reset_in_between:
                self.ngram.reset()
            t0 = time.time()
            out, rate = ngram_assisted_speculative_generate(
                ids, self.ngram, self.target_cfg, self.target_params,
                gamma=self.gamma, filler_top_k=self.top_k_filler,
                debug=self.debug, **common)
            dt = time.time() - t0
            results["ngram"] = (out, dt)
            print(f"[ngram-assist] ({dt:.2f}s, accept {rate:.3f}) "
                  f"{self.tokenizer.decode(out)}")

        if self.target_gen:
            t0 = time.time()
            out = autoregressive_generate(
                ids, self.target_cfg, self.target_params, **common)
            dt = time.time() - t0
            results["target"] = (out, dt)
            print(f"[target AR]    ({dt:.2f}s) {self.tokenizer.decode(out)}")

        if self.dr and self.eagle_drafter:
            print("[drafter AR]   n/a: an eagle drafter has no standalone "
                  "AR mode (it predicts features, not tokens, and reuses "
                  "the target's head)")
        elif self.dr:
            t0 = time.time()
            out = autoregressive_generate(
                ids, self.drafter_cfg, self.drafter_params, **common)
            dt = time.time() - t0
            results["drafter"] = (out, dt)
            print(f"[drafter AR]   ({dt:.2f}s) {self.tokenizer.decode(out)}")

        # throughput ratios against target AR
        if "target" in results:
            base_out, base_dt = results["target"]
            base_tps = len(base_out) / base_dt if base_dt > 0 else 0
            for name, (out, dt) in results.items():
                if name == "target" or dt <= 0:
                    continue
                tps = len(out) / dt
                if base_tps > 0:
                    print(f"  throughput {name}/target: {tps / base_tps:.2f}x "
                          f"({tps:.1f} vs {base_tps:.1f} tok/s)")
        return results

    # --------------------------------------------------------------- commands
    def _perform_command(self, command: str):
        args = command.split(" ")
        cmd = args[0]
        toggles = {
            "/speculative": "spec", "/target": "target_gen", "/drafter": "dr",
            "/ngram": "ngram_gen", "/chat": "chat", "/debug": "debug",
            "/cache": "cache", "/reset_in_between": "reset_in_between",
        }
        if cmd == "/quit":
            print("Goodbye!")
            raise SystemExit(0)
        if cmd in toggles:
            attr = toggles[cmd]
            setattr(self, attr, not getattr(self, attr))
            print(f"{attr}: {getattr(self, attr)}")
            return
        if cmd == "/clear":
            os.system("cls" if os.name == "nt" else "clear")
            return
        if cmd in ("/length", "/gamma", "/top_k_filler"):
            if len(args) < 2:
                print(f"Usage: {cmd} <value>")
                return
            attr = {"/length": "gen_len", "/gamma": "gamma",
                    "/top_k_filler": "top_k_filler"}[cmd]
            setattr(self, attr, int(args[1]))
            print(f"{attr}: {int(args[1])}")
            return
        if cmd == "/processor":
            if len(args) < 2 or args[1] not in PROCESSORS:
                print(f"Usage: /processor <{'/'.join(PROCESSORS)}> <args...>")
                return
            spec = PROCESSORS[args[1]]
            vals, rest = {}, args[2:]
            for name, typ in spec["args"].items():
                if not rest:
                    print(f"Missing argument {name}")
                    return
                try:
                    vals[name] = typ(rest.pop(0))
                except ValueError:
                    print(f"Invalid argument {name} (expected {typ.__name__})")
                    return
            self.processor = spec["cls"](**vals)
            print(f"processor: {args[1]} {vals}")
            return
        if cmd == "/set_ngramstorage":
            if len(args) < 3:
                print("Usage: /set_ngramstorage <basic/onelevel> <n>")
                return
            ntype = {"basic": NGramStorage,
                     "onelevel": OneLevelNGramStorage}.get(args[1])
            if ntype is None:
                print("Invalid ngram type")
                return
            self.ngram_n = int(args[2])
            self.ngram = ntype(n=self.ngram_n,
                               vocab_size=self.target_cfg.vocab_size)
            print(f"ngram: {args[1]} n={self.ngram_n}")
            return
        if cmd == "/random":
            prompt = self._get_random_prompt()
            print(f"random prompt: {prompt!r}")
            self._infer(prompt)
            return
        print("Unknown command")
        self._help()

    def _help(self):
        print("Commands: /speculative /target /drafter /ngram /gamma <n> "
              "/length <n> /processor <name> <args> /cache /chat /debug "
              "/set_ngramstorage <basic|onelevel> <n> /top_k_filler <n> "
              "/reset_in_between /random /clear /quit; 'auto <n>' runs n "
              "random prompts")

    def run(self):
        self._help()
        while True:
            try:
                line = input("> ").strip()
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not line:
                continue
            if line.startswith("/"):
                self._perform_command(line)
            elif line.startswith("auto"):
                parts = line.split()
                n = int(parts[1]) if len(parts) > 1 else 5
                for _ in range(n):
                    prompt = self._get_random_prompt()
                    print(f"\nprompt: {prompt!r}")
                    self._infer(prompt)
            else:
                self._infer(line)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="interactive comparison REPL (PyTorch/CUDA port)")
    ap.add_argument("--target-model", default=None)
    ap.add_argument("--drafter-model", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)
    InferenceCLI(args.target_model, args.drafter_model,
                 device=args.device).run()


if __name__ == "__main__":
    main()
