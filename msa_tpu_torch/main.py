"""The command line (port of ``msa_tpu/main.py``):

    python -m msa_tpu_torch.main --mode offline --video clip.npz [--device cuda]
    python -m msa_tpu_torch.main --mode streaming [--duration 5] [--max-segments N]

The reference's argparse surface (``--mode offline|streaming``,
``--video``, ``--duration``, ``--hf-token``), its callbacks, and its
JSON-lines sink: each result is appended to ``<output-dir>/results.json``
as one line. Logs go to ``logs/`` and the working directories are made
under the working directory. Warmup is on unless ``MSA_PRECOMPILE`` says
otherwise. ``--device`` (default ``cuda``) is where the models run.

Offline mode reads a container through cv2, or a frame archive (``.npz``
with ``frames`` and ``fps``) with its sidecar WAV where there is neither
cv2 nor ffmpeg (``host/video.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from pathlib import Path

from msa_tpu_torch.core.config import SystemConfig
from msa_tpu_torch.utils.logging_config import setup_logging
from msa_tpu_torch.utils.misc import create_directories

logger = logging.getLogger(__name__)


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.ndarray,)):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    return str(o)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Análise de Sentimentos Multimodal (GPU)")
    parser.add_argument(
        "--mode", choices=["offline", "streaming"], required=True, help="Modo de operação: offline ou streaming"
    )
    parser.add_argument("--video", help="Caminho do vídeo para processamento offline")
    parser.add_argument(
        "--duration", type=float, default=5.0, help="Duração de cada segmento em streaming (segundos)"
    )
    parser.add_argument("--hf-token", help="Token do HuggingFace (modelos opcionais)")
    parser.add_argument("--output-dir", default="output")
    parser.add_argument("--max-segments", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="Dispositivo dos modelos (cuda, cuda:N ou cpu)")
    args = parser.parse_args(argv)

    log_file = setup_logging()
    create_directories()
    logger.info("iniciando aplicação (logs: %s)", log_file)

    config = SystemConfig.from_env()
    if args.hf_token:
        config = dataclasses.replace(config, model=dataclasses.replace(config.model, hf_token=args.hf_token))
    if "MSA_PRECOMPILE" not in os.environ:
        # the CLI's default: every shape runs once up front, so that no
        # window or batch meets a first-call cost mid-run
        config = dataclasses.replace(config, pipeline=dataclasses.replace(config.pipeline, precompile=True))

    results_path = Path(args.output_dir) / "results.json"
    results_path.parent.mkdir(parents=True, exist_ok=True)

    def on_result(result):
        # the JSON-lines sink: one result a line, appended
        with open(results_path, "a") as f:
            json.dump(result, f, default=_json_default)
            f.write("\n")

    def on_error(error):
        logger.error("erro durante processamento: %s", error)

    def on_progress(progress: float):
        logger.info("progresso: %.1f%%", progress * 100)

    if args.mode == "offline":
        if not args.video:
            parser.error("--video é obrigatório no modo offline")
        from msa_tpu_torch.processors.offline import OfflineProcessor

        processor = OfflineProcessor(config=config, device=args.device)
        speakers = processor.process_video(args.video, on_result=on_result, on_error=on_error, on_progress=on_progress)
        for sp in speakers:
            logger.info(
                "%s: dominante=%s, %d segmentos, %d padrões",
                sp["person"],
                sp["dominant_emotion"],
                len(sp["segments"]),
                len(sp["patterns"]),
            )
        print(json.dumps({"speakers": len(speakers), "results": str(results_path)}))
    else:
        from msa_tpu_torch.processors.streaming import StreamingProcessor

        processor = StreamingProcessor(config=config, show_window=bool(os.getenv("DISPLAY")), device=args.device)
        processor.run(duration=args.duration, callback=on_result, max_segments=args.max_segments)
        print(json.dumps({"results": str(results_path)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
