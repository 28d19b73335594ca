"""Data-service entry point of the port, the counterpart of the JAX
package's ``scripts/serve.py`` (reference: dashboard/run_production.sh +
gunicorn scripts).

Serves observations + embedding stores + optional model inference over the
REST API in ``deepearth_tpu_torch.serving``.

Usage:
    python -m deepearth_tpu_torch.cli.serve --observations obs.parquet \\
        --vision-store /data/vision --port 8080 --with-predictor

``--with-predictor`` exposes /api/predict through a fresh
``api.DeepEarth`` on ``--device`` (``cuda``, the default, or ``cpu``).
"""

from __future__ import annotations

import argparse
import time

from ..data import MMapEmbeddingLoader, ObservationDataset
from ..serving import DashboardServer, DataService
from ..utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="DeepEarth data service (PyTorch)")
    ap.add_argument("--observations", type=str, default=None,
                    help="observations parquet file")
    ap.add_argument("--vision-store", type=str, default=None,
                    help="mmap store prefix for vision embeddings")
    ap.add_argument("--language-store", type=str, default=None)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--with-predictor", action="store_true",
                    help="expose /api/predict with a fresh DeepEarth model")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the predictor runs: cuda (the default) or cpu")
    return ap


def start(argv=None) -> DashboardServer:
    """Parse ``argv``, build the service and start its server in the
    background; the caller stops it."""
    args = build_parser().parse_args(argv)
    setup_logging()

    observations = None
    if args.observations:
        ds = ObservationDataset.from_parquet(args.observations)
        observations = ds.columns()

    vision = MMapEmbeddingLoader(args.vision_store) if args.vision_store else None
    language = (
        MMapEmbeddingLoader(args.language_store) if args.language_store else None
    )

    predictor = None
    if args.with_predictor:
        from ..api import DeepEarth

        predictor = DeepEarth(device=args.device)
        predictor.register("species", type="categorical", num_classes=232)

    service = DataService(
        observations=observations,
        vision_loader=vision,
        language_loader=language,
        predictor=predictor,
    )
    return DashboardServer(service, host=args.host, port=args.port).start()


def main(argv=None) -> None:
    server = start(argv)
    print(f"serving on http://{server.host}:{server.port} — Ctrl-C to stop",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
