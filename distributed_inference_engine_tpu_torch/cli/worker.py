"""Worker daemon CLI of the port (same flags and ``--model`` parsing as
the JAX package's ``cli/worker.py``):

    python -m distributed_inference_engine_tpu_torch.cli.worker \\
        --worker-id w0 --port 9000 \\
        --model name=llama8b,architecture=llama,size=llama3-8b,continuous=1,attention_impl=pallas-decode

Each ``--model`` is ``key=value`` pairs; unknown keys land in
``ModelConfig.metadata``. With no ``--model`` the worker starts empty, for
a fleet to deploy over ``load_model``. ``--config file.{json,toml}``
takes the server settings and the models to preload from the file
instead (``config.load_config``). ``--device`` picks the torch device
(default the card). ``path=<dir>`` serves an HF safetensors checkpoint
or a native one of the port; ``artifact=<dir>`` cold-starts from a
serving artifact there (written on the first, slow boot);
``--artifact-dir DIR`` gives every model without its own
``artifact=`` the artifact ``DIR/<name>``. Flags of features the port
lacks (``--multihost`` and its coordinates, a config file's multihost
section) raise.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
from typing import Any, Dict, List

import torch

from ..config import ModelConfig, ServerConfig, load_config
from ..cluster.worker import WorkerServer

_MODEL_FIELDS = {
    "name", "path", "version", "architecture", "dtype", "batch_size",
    "max_batch_size", "max_seq_len", "quantized",
}
_INT_FIELDS = {"batch_size", "max_batch_size", "max_seq_len",
               "page_size", "num_pages", "decode_steps_per_call"}
_BOOL_FIELDS = {"quantized", "continuous"}


def parse_model_arg(text: str) -> ModelConfig:
    """``name=tiny,architecture=llama,size=llama-tiny,continuous=1`` ->
    ModelConfig (unknown keys go to metadata)."""
    fields: Dict[str, Any] = {}
    metadata: Dict[str, Any] = {}
    for part in text.split(","):
        if "=" not in part:
            raise ValueError(f"model spec part {part!r} is not key=value")
        k, v = part.split("=", 1)
        k = k.strip()
        val: Any = v.strip()
        if k in _INT_FIELDS:
            val = int(val)
        elif k in _BOOL_FIELDS:
            val = val.lower() in ("1", "true", "yes", "on")
        (fields if k in _MODEL_FIELDS else metadata)[k] = val
    if "name" not in fields:
        raise ValueError(f"model spec {text!r} missing name=")
    fields["metadata"] = metadata
    return ModelConfig(**fields)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_inference_engine_tpu_torch.cli.worker",
        description="PyTorch/CUDA inference worker (framed-RPC server)")
    p.add_argument("--worker-id", default="worker-0")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = OS-assigned (printed at startup)")
    p.add_argument("--model", action="append", default=[],
                   metavar="K=V[,K=V...]", help="model to preload "
                   "(repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engines (default: cuda)")
    p.add_argument("--config", default="",
                   help="config file (.json/.toml): server and model "
                   "settings come from the file")
    p.add_argument("--artifact-dir", default="",
                   help="serving-artifact root: each model without its own "
                   "artifact= cold-starts from <dir>/<name>")
    p.add_argument("--multihost", action="store_true", help="not ported yet")
    p.add_argument("--coordinator-address", default="",
                   help="not ported yet")
    p.add_argument("--num-processes", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--process-id", type=int, default=-1,
                   help="not ported yet")
    p.add_argument("--log-level", default="INFO")
    return p


def _reject_unported(args: argparse.Namespace) -> None:
    for flag, on, item in (
            ("--multihost", args.multihost, "A13"),
            ("--coordinator-address", args.coordinator_address, "A13"),
            ("--num-processes", args.num_processes, "A13"),
            ("--process-id", args.process_id >= 0, "A13")):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch worker yet "
                f"(ROADMAP.md {item})")


async def amain(args: argparse.Namespace) -> None:
    _reject_unported(args)
    if args.config:
        cfg = load_config(args.config)
        if cfg.multihost.enabled:
            raise NotImplementedError(
                "a config file's multihost section is not ported to the "
                "PyTorch worker yet (ROADMAP.md A13)")
        server_cfg, models = cfg.server, cfg.models
    else:
        server_cfg = ServerConfig(worker_id=args.worker_id, host=args.host,
                                  port=args.port)
        models = [parse_model_arg(m) for m in args.model]
    if args.artifact_dir:
        for m in models:
            # a model's own artifact= wins over the shared root
            m.metadata.setdefault(
                "artifact", os.path.join(args.artifact_dir, m.name))
    device = torch.device(args.device)
    if device.type == "cuda":
        # the process's context on the card exists before the first
        # load, so its memory reads the same before a load and after the
        # matching unload
        torch.cuda.init()
        torch.empty(0, device=device)
    worker = WorkerServer(server_cfg, device=args.device)
    # preload BEFORE announcing the address: the "listening" line is the
    # readiness signal launchers wait on
    for m in models:
        print(f"loading model {m.name} ({m.architecture})...", flush=True)
        await worker.load_model_async(m)
        if m.name in worker._last_warmup:
            rounds, secs = worker._last_warmup[m.name]
            print(f"warmed model {m.name}: {rounds} rounds in {secs:.2f}s",
                  flush=True)
        cold = getattr(worker.engines.get(m.name), "artifact_manifest",
                       None) is not None
        print(f"loaded model {m.name} in "
              f"{worker._last_load_s.get(m.name, 0.0):.2f}s"
              f"{' [artifact cold-start]' if cold else ''}", flush=True)
    host, port = await worker.start(install_signal_handlers=True)
    print(f"worker {worker.worker_id} listening on {host}:{port}", flush=True)
    await worker.serve_forever()


def main(argv: List[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
