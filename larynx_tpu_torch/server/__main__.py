"""Run the port's HTTP server: ``python -m larynx_tpu_torch.server``.

Counterpart of ``larynx_tpu/server/__main__.py``: the same flags plus
``--device`` (default ``cuda``: with no GPU the server does not start), and
the same pidfile/daemon lifecycle (SIGTERM graceful shutdown, exit if the
pidfile holds a live pid).
"""

import argparse
import asyncio
import logging
import os
import signal
import sys
from pathlib import Path

from aiohttp import web

from larynx_tpu_torch.server.app import ServerSettings, create_app
from larynx_tpu_torch.voices import DEFAULT_VOICE_URL_FORMAT

_LOGGER = logging.getLogger("larynx_tpu_torch.server")


def get_args(argv=None):
    parser = argparse.ArgumentParser(prog="larynx_tpu_torch.server")
    parser.add_argument(
        "--host", default="0.0.0.0", help="Host of HTTP server (default: 0.0.0.0)"
    )
    parser.add_argument(
        "--port", type=int, default=5002, help="Port of HTTP server (default: 5002)"
    )
    parser.add_argument(
        "--voices-dir",
        help="Directory with <LANGUAGE>/<VOICE> structure (overrides "
        "LARYNX_VOICES_DIR env variable)",
    )
    parser.add_argument(
        "--quality",
        choices=["high", "medium", "low"],
        default="high",
        help="Vocoder quality used if not set in API call (default: high)",
    )
    parser.add_argument(
        "--denoiser-strength",
        type=float,
        default=0.005,
        help="Denoiser strength used if not set in API call (default: 0.005)",
    )
    parser.add_argument(
        "--noise-scale",
        type=float,
        default=0.667,
        help="Noise scale used if not set in API call (default: 0.667)",
    )
    parser.add_argument(
        "--length-scale",
        type=float,
        default=1.0,
        help="Length scale (<1 is faster) used if not set in API call",
    )
    parser.add_argument(
        "--url-format",
        default=DEFAULT_VOICE_URL_FORMAT,
        help="Format string for download URLs (accepts {voice})",
    )
    parser.add_argument(
        "--pidfile", help="Path to pidfile. Exit if pidfile already exists."
    )
    parser.add_argument("--logfile", help="Path to logging file (default: stderr)")
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device to synthesize on (default: cuda)",
    )
    parser.add_argument(
        "--cuda", action="store_true",
        help="Accepted for compatibility (--device picks the device)",
    )
    parser.add_argument(
        "--half", action="store_true", help="Use bfloat16 compute on the GPU"
    )
    parser.add_argument(
        "--max-batch", type=int, default=8,
        help="Maximum sentences per batched call (default: 8)",
    )
    parser.add_argument(
        "--workers", type=int, default=ServerSettings.workers,
        help="Synthesis worker threads (default: %(default)s; concurrent "
        "requests coalesce into shared device batches)",
    )
    parser.add_argument(
        "--preload-voice",
        action="append",
        default=[],
        help="Voice to load + warm at startup (repeatable)",
    )
    parser.add_argument(
        "--debug", action="store_true", help="Print DEBUG messages to console"
    )
    return parser.parse_args(argv)


def _pid_running(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        # EPERM: the process exists but belongs to another user
        return True


def main(argv=None) -> None:
    args = get_args(argv)

    log_args = {"level": logging.DEBUG if args.debug else logging.INFO}
    if args.logfile:
        log_args["filename"] = args.logfile
    logging.basicConfig(**log_args)
    _LOGGER.debug(args)

    pidfile_path = Path(args.pidfile) if args.pidfile else None
    if pidfile_path is not None:
        pidfile_path.parent.mkdir(parents=True, exist_ok=True)
        if pidfile_path.is_file():
            try:
                existing = int(pidfile_path.read_text().strip())
                if _pid_running(existing):
                    _LOGGER.info(
                        "Daemon already running (pidfile=%s). Exiting now.",
                        pidfile_path,
                    )
                    sys.exit(0)
            except ValueError:
                pass
        pidfile_path.write_text(str(os.getpid()))
        _LOGGER.debug("pidfile: %s", pidfile_path)

    settings = ServerSettings(
        voices_dir=args.voices_dir,
        quality=args.quality,
        denoiser_strength=args.denoiser_strength,
        noise_scale=args.noise_scale,
        length_scale=args.length_scale,
        url_format=args.url_format,
        half=args.half,
        max_batch=args.max_batch,
        workers=args.workers,
        preload_voices=tuple(args.preload_voice),
        device=args.device,
    )
    # what runs in float32 runs in float32, as in the CLI: cuDNN's default
    # would run the convs in TF32
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    shutdown_event = asyncio.Event()

    def _signal_handler(*_args) -> None:
        loop.call_soon_threadsafe(shutdown_event.set)

    try:
        loop.add_signal_handler(signal.SIGTERM, _signal_handler)
    except NotImplementedError:
        pass

    async def serve():
        runner = web.AppRunner(create_app(settings))
        await runner.setup()
        site = web.TCPSite(runner, args.host, args.port)
        await site.start()
        _LOGGER.info("Server running at http://%s:%s on %s", args.host, args.port, args.device)
        await shutdown_event.wait()
        await runner.cleanup()

    try:
        loop.run_until_complete(serve())
    except KeyboardInterrupt:
        pass
    finally:
        # also when the app cannot start (no GPU for --device cuda): a
        # daemon's caller then finds no stale pidfile
        if pidfile_path is not None:
            pidfile_path.unlink(missing_ok=True)

if __name__ == "__main__":
    main()
