"""Batched LM serving on the port: prefill + slot-based decode over the
serving engine.

The reference's ``examples/serve_lm.py`` on ``repro_torch``: the smoke
config's prefill (K5) and decode steps (K6) run on the card; tokens are
sampled at temperature 0.8 from the engine's ``torch.Generator``, seeded 0.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch rwkv6_1_6b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run (cpu: their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(get_arch(args.arch))
    model = build_model(cfg, max_seq_len=128)
    params = model.init(0, device=dev)
    engine = ServeEngine(model, params,
                         ServeConfig(max_len=128, n_slots=4,
                                     temperature=0.8, seed=0),
                         device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, 8 + i,
                                    dtype=np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    engine.generate(reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] → "
              f"{len(r.output)} tokens: {r.output[:12]}…")
    if not all(r.done for r in reqs):
        raise RuntimeError("a request was left unfinished")
    print(f"served {len(reqs)} requests on {cfg.name} "
          f"({cfg.family}) with slot batching")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
