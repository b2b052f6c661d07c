#!/usr/bin/env python3
"""larynx_tpu_torch command line interface: ``python -m larynx_tpu_torch``.

Counterpart of ``larynx_tpu/__main__.py``, with the same flags and output
modes: text from arguments or stdin (lines, one document, blank-line
paragraphs, id|text CSV), output as one WAV on stdout, per-sentence WAV
files, interactive playback, a raw PCM stream per sentence
(``--raw-stream``) or per vocoder chunk (``--stream``), the voice list and
an SSML mark file.  ``--device`` (default ``cuda``) picks the device, as the
library's ``device=`` does.  ``--daemon`` starts (or reuses) the port's HTTP
server in the background on that device and synthesises through its
``/api/tts``; ``--stop-daemon`` stops it.
"""

import argparse
import io
import logging
import os
import shlex
import string
import subprocess
import sys
import threading
import time
import typing
import urllib.parse
import urllib.request
from enum import Enum
from pathlib import Path
from queue import Queue

from larynx_tpu_torch.constants import InferenceBackend
from larynx_tpu_torch.voices import (
    DEFAULT_VOICE_URL_FORMAT,
    VOCODER_ALIASES,
    get_runtime_dir,
    get_voices_dirs,
    list_voices,
    valid_voice_dir,
)

_LOGGER = logging.getLogger("larynx_tpu_torch")

VOCODER_DIR_NAMES = {"hifi_gan", "waveglow"}
# beside the JAX package's daemon.pidfile / daemon.log in the same runtime
# dir: the two packages' daemons are told apart
DAEMON_PIDFILE = "torch_daemon.pidfile"
DAEMON_LOGFILE = "torch_daemon.log"


def _isatty(stream) -> bool:
    try:
        return os.isatty(stream.fileno())
    except (OSError, ValueError, io.UnsupportedOperation):
        return False


class OutputNaming(str, Enum):
    TEXT = "text"
    TIME = "time"
    ID = "id"


class StdinFormat(str, Enum):
    AUTO = "auto"
    LINES = "lines"
    DOCUMENT = "document"


# Copied from larynx_tpu/__main__.py (_paragraphs, _PcmStreamWriter,
# _play_wav, _output_file_stem, _list_voices_vocoders).
def _paragraphs(lines: typing.Iterable[str]) -> typing.Iterator[str]:
    """Join consecutive non-blank lines into one text per paragraph.

    A blank line flushes the pending paragraph.  Input must end with a
    blank line, otherwise the trailing paragraph is not emitted (streaming
    use), as in the reference's ``--process-on-blank-line``.
    """
    pending: typing.List[str] = []
    for raw in lines:
        stripped = raw.strip()
        if stripped:
            pending.append(stripped)
        elif pending:
            yield " ".join(pending)
            pending.clear()


class _PcmStreamWriter:
    """Background stdout writer for ``--raw-stream`` 16-bit PCM.

    Synthesis pushes byte chunks through a bounded queue (backpressure keeps
    memory flat on long documents); a daemon thread drains it to stdout.
    """

    _DONE = None

    def __init__(self, queue_size: int):
        self._queue: "Queue[typing.Optional[bytes]]" = Queue(maxsize=queue_size)
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        out = sys.stdout.buffer
        for chunk in iter(self._queue.get, self._DONE):
            _LOGGER.debug("Streaming %d byte(s) of 16-bit mono PCM", len(chunk))
            out.write(chunk)
            out.flush()

    def put(self, chunk: bytes) -> None:
        self._queue.put(chunk)

    def abort(self) -> None:
        """Drop anything queued (Ctrl-C path) without killing the thread."""
        while not self._queue.empty():
            self._queue.get_nowait()

    def close(self) -> None:
        self._queue.put(self._DONE)
        self._thread.join()


def _play_wav(wav_data: bytes, play_command: str) -> None:
    """Pipe a WAV to the user's player; fall back to a file if it's absent."""
    try:
        subprocess.run(
            shlex.split(play_command),
            input=wav_data,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            check=True,
        )
    except FileNotFoundError:
        fallback = Path("output.wav")
        fallback.write_bytes(wav_data)
        _LOGGER.error(
            "Audio player %r not found (set --play-command or redirect "
            "stdout); wrote %s instead",
            play_command,
            fallback,
        )


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:  # exists, other user
        return True


def _spawn_daemon(port: int, pidfile_path: Path, logfile: Path,
                  server_args: typing.Sequence[str] = ()) -> None:
    """Reuse a live daemon, else launch ``python -m larynx_tpu_torch.server``
    with ``server_args`` and wait until it answers (as
    ``larynx_tpu/__main__.py::_spawn_daemon``; a server that exits before it
    answers raises at once)."""
    if pidfile_path.is_file():
        try:
            pid = int(pidfile_path.read_text().strip() or "0")
        except ValueError:
            pid = 0
        if pid and _pid_alive(pid):
            _LOGGER.debug("Daemon already running (pid=%s)", pid)
        else:
            # stale pidfile of a crashed daemon: the wait below must watch
            # the new server's file
            pidfile_path.unlink(missing_ok=True)

    proc = None
    if not pidfile_path.is_file():
        server_argv = [
            sys.executable, "-m", "larynx_tpu_torch.server",
            "--host", "127.0.0.1",
            "--port", str(port),
            "--pidfile", str(pidfile_path),
            "--logfile", str(logfile),
            *server_args,
        ]
        proc = subprocess.Popen(server_argv, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    # the pidfile appears before the port binds (model loading can take a
    # while), and a daemon found above may still be starting: wait until
    # the server answers
    deadline = time.monotonic() + 300.0
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the daemon exited with code {proc.returncode} before it "
                               f"answered; see {logfile}")
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/version", timeout=2).read()
            _LOGGER.info("Daemon running (pid=%s)", pidfile_path.read_text().strip())
            return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError(f"daemon on port {port} did not come up")


def _synthesize_via_daemon(args) -> bytes:
    """One /api/tts round trip against the daemon, with the call's voice,
    quality, SSML flag and synthesis settings."""
    text = " ".join(args.text) if args.text else sys.stdin.read()
    query = {
        "voice": args.voice, "text": text, "vocoder": args.quality,
        "noiseScale": args.noise_scale, "lengthScale": args.length_scale,
        "denoiserStrength": args.denoiser_strength,
    }
    if args.ssml:
        query["ssml"] = "true"
    url = f"http://127.0.0.1:{args.daemon_port}/api/tts?" + urllib.parse.urlencode(query)
    start = time.perf_counter()
    with urllib.request.urlopen(url) as response:
        wav_data = response.read()
    _LOGGER.debug("Got %s byte(s) of WAV data in %s second(s)", len(wav_data),
                  time.perf_counter() - start)
    return wav_data


def _stop_daemon() -> None:
    """SIGTERM the daemon of the pidfile, wait up to 5 s, remove the pidfile."""
    import signal

    pidfile = get_runtime_dir() / DAEMON_PIDFILE
    if not pidfile.is_file():
        _LOGGER.info("No daemon running")
        return
    try:
        daemon_pid = int(pidfile.read_text().strip())
        os.kill(daemon_pid, signal.SIGTERM)
        for _ in range(50):
            if not _pid_alive(daemon_pid):
                break
            time.sleep(0.1)
        _LOGGER.info("Stopped daemon")
    except (ValueError, ProcessLookupError):
        _LOGGER.info("Daemon not running")
    pidfile.unlink(missing_ok=True)


# -----------------------------------------------------------------------------


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> None:
    args = get_args(argv)

    # --language picks that language's default voice unless --voice is given
    if not args.voice:
        args.voice = args.language or "en-us"

    audio_settings_overrides = None
    if args.config:
        import json

        with open(args.config, "r", encoding="utf-8") as f:
            loaded = json.load(f)
        # accept either a bare audio dict or a full voice config.json
        audio_settings_overrides = loaded.get("audio", loaded)

    backend: typing.Optional[InferenceBackend] = None
    if args.backend:
        backend = InferenceBackend(args.backend)

    if args.cuda:
        _LOGGER.warning("--cuda is a no-op: --device picks the device (default cuda)")

    # ------------------------------------------------------------------
    # Daemon mode: spawn/reuse the background HTTP server, then query it
    # ------------------------------------------------------------------
    if args.daemon:
        runtime_dir = get_runtime_dir()
        server_args = ["--device", args.device]
        if args.voices_dir:
            server_args += ["--voices-dir", str(args.voices_dir)]
        if args.half:
            server_args.append("--half")
        _LOGGER.debug("Trying to start daemon on port %s", args.daemon_port)
        _spawn_daemon(args.daemon_port, runtime_dir / DAEMON_PIDFILE,
                      runtime_dir / DAEMON_LOGFILE, server_args)
        sys.stdout.buffer.write(_synthesize_via_daemon(args))
        sys.stdout.buffer.flush()
        return

    # ------------------------------------------------------------------
    # Direct synthesis
    # ------------------------------------------------------------------
    import numpy as np
    import torch

    from larynx_tpu_torch import stream_text_to_speech, text_to_speech
    from larynx_tpu_torch.io.wavfile import write as wav_write

    # what runs in float32 runs in float32: cuDNN's default would run the convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.stream:
        # chunked low-latency path: PCM to stdout as the vocoder produces it
        out = sys.stdout.buffer
        source = " ".join(args.text) if args.text else sys.stdin.read()
        for chunk in stream_text_to_speech(
            source,
            voice_or_lang=args.voice,
            vocoder_or_quality=args.quality,
            ssml=args.ssml,
            backend=backend,
            tts_settings={
                "noise_scale": args.noise_scale,
                "length_scale": args.length_scale,
            },
            denoiser_strength=args.denoiser_strength,
            half=args.half,
            custom_voices_dir=args.voices_dir,
            url_format=args.url_format,
            seed=args.seed,
            chunk_frames=args.stream_chunk_frames,
            no_download=args.no_download,
            device=args.device,
        ):
            out.write(chunk.tobytes())
            out.flush()
        return

    if args.output_dir:
        args.output_dir = Path(args.output_dir)
        args.output_dir.mkdir(parents=True, exist_ok=True)

    mark_writer: typing.Optional[typing.TextIO] = None
    if args.mark_file:
        args.mark_file = Path(args.mark_file)
        args.mark_file.parent.mkdir(parents=True, exist_ok=True)
        mark_writer = open(args.mark_file, "w", encoding="utf-8")

    if args.csv:
        args.output_naming = "id"

    # Input sources
    if args.text:
        texts: typing.Iterable[str] = args.text
    else:
        if args.stdin_format == StdinFormat.AUTO:
            # SSML documents span lines; plain text synthesizes per line
            stdin_format = StdinFormat.DOCUMENT if args.ssml else StdinFormat.LINES
        else:
            stdin_format = StdinFormat(args.stdin_format)
        if stdin_format == StdinFormat.DOCUMENT:
            texts = [sys.stdin.read()]
        else:
            texts = sys.stdin
        if _isatty(sys.stdin):
            print("Reading text from stdin...", file=sys.stderr)

    if args.process_on_blank_line:
        texts = _paragraphs(texts)

    if _isatty(sys.stdout):
        if not args.output_dir and not args.raw_stream:
            args.interactive = True

    pcm_stream: typing.Optional[_PcmStreamWriter] = None
    if args.raw_stream:
        pcm_stream = _PcmStreamWriter(int(args.raw_stream_queue_size))

    all_audios: typing.List[np.ndarray] = []
    sample_rate = 22050

    tts_settings = {
        "noise_scale": args.noise_scale,
        "length_scale": args.length_scale,
    }
    vocoder_settings = {"denoiser_strength": args.denoiser_strength}

    start_time_to_first_audio = time.perf_counter()
    try:
        for line in texts:
            line_id = ""
            line = line.strip()
            if not line:
                continue
            if args.output_naming == OutputNaming.ID.value:
                line_id, line = line.split(args.id_delimiter, maxsplit=1)

            tts_results = text_to_speech(
                text=line,
                voice_or_lang=args.voice,
                ssml=args.ssml,
                vocoder_or_quality=args.quality,
                backend=backend,
                half=args.half,
                denoiser_strength=args.denoiser_strength,
                tts_settings=tts_settings,
                vocoder_settings=vocoder_settings,
                custom_voices_dir=args.voices_dir,
                url_format=args.url_format,
                max_batch=args.max_batch,
                seed=args.seed,
                no_download=args.no_download,
                audio_settings_overrides=audio_settings_overrides,
                device=args.device,
            )

            text_id = ""
            for result_idx, result in enumerate(tts_results):
                text = result.text
                if result_idx == 0:
                    _LOGGER.debug(
                        "Seconds to first audio: %s",
                        time.perf_counter() - start_time_to_first_audio,
                    )
                sample_rate = result.sample_rate

                if result.marks_before and mark_writer:
                    for mark_name in result.marks_before:
                        print(mark_name, file=mark_writer)

                if args.raw_stream:
                    pcm_stream.put(result.audio.tobytes())
                elif args.interactive or args.output_dir:
                    with io.BytesIO() as wav_io:
                        wav_write(wav_io, result.sample_rate, result.audio)
                        wav_data = wav_io.getvalue()

                    if args.interactive:
                        _LOGGER.debug("Playing audio with play command")
                        _play_wav(wav_data, args.play_command)

                    if args.output_dir:
                        if args.output_naming == OutputNaming.ID.value:
                            text_id = line_id if not text_id else f"{line_id}_{result_idx + 1}"
                        file_name = _output_file_stem(args.output_naming, text, text_id)
                        if not file_name:
                            raise ValueError(f"No file name for text: {text}")
                        wav_path = args.output_dir / (file_name + ".wav")
                        with open(wav_path, "wb") as wav_file:
                            wav_write(wav_file, sample_rate, result.audio)
                        _LOGGER.debug("Wrote %s", wav_path)
                else:
                    all_audios.append(result.audio)

                if result.marks_after and mark_writer:
                    for mark_name in result.marks_after:
                        print(mark_name, file=mark_writer)
    except KeyboardInterrupt:
        if pcm_stream is not None:
            pcm_stream.abort()
    finally:
        if pcm_stream is not None:
            pcm_stream.close()
        if mark_writer is not None:
            mark_writer.close()

    if all_audios:
        _LOGGER.debug("Writing WAV audio to stdout")
        buf = io.BytesIO()
        wav_write(buf, sample_rate, np.concatenate(all_audios))
        sys.stdout.buffer.write(buf.getvalue())
        sys.stdout.buffer.flush()


def _output_file_stem(naming: str, text: str, text_id: str) -> str:
    """WAV file stem for --output-dir per the --output-naming scheme."""
    if naming == OutputNaming.TIME.value:
        return str(time.time())
    if naming == OutputNaming.ID.value:
        return text_id
    # TEXT: underscores for spaces, punctuation stripped
    drop = string.punctuation.replace("_", "")
    return text.strip().replace(" ", "_").translate(str.maketrans("", "", drop))


# -----------------------------------------------------------------------------


def _list_voices_vocoders(voices_dirs: typing.List[Path]) -> None:
    """Print the voices/vocoders table (parity: larynx/__main__.py:637-742)."""
    local_info: typing.Dict[typing.Tuple[str, str], str] = {}
    for voices_dir in voices_dirs:
        if not voices_dir.is_dir():
            continue
        for voice_dir in voices_dir.iterdir():
            if not voice_dir.is_dir():
                continue
            if voice_dir.name in VOCODER_DIR_NAMES:
                for vocoder_model_dir in voice_dir.iterdir():
                    if valid_voice_dir(vocoder_model_dir):
                        full = f"{voice_dir.name}-{vocoder_model_dir.name}"
                        local_info[("vocoder", full)] = str(vocoder_model_dir)
            else:
                for voice_model_dir in voice_dir.iterdir():
                    if valid_voice_dir(voice_model_dir):
                        local_info[("voice", voice_model_dir.name)] = str(voice_model_dir)

    rows = []
    vocoder_alias_map: typing.Dict[str, typing.List[str]] = {}
    for alias, full in VOCODER_ALIASES.items():
        vocoder_alias_map.setdefault(full, []).append(alias)
    for full, aliases in vocoder_alias_map.items():
        location = local_info.get(("vocoder", full), "")
        rows.append(
            (
                "vocoder",
                " ",
                "*" if location else " ",
                full,
                ",".join(a for a in aliases if a != full),
                location,
            )
        )

    known_names = set()
    for canonical, lang, _gender in list_voices():
        name = canonical.split("_", maxsplit=1)[1]  # <name>-glow_tts
        known_names.add(name)
        location = local_info.get(("voice", name), "")
        alias = name.rsplit("-", 1)[0]
        rows.append(("voice", lang, "*" if location else " ", name, alias, location))

    # local-only voices not in the registry
    for (kind, name), location in local_info.items():
        if kind == "voice" and name not in known_names:
            lang = Path(location).parent.name
            alias = name.rsplit("-", 1)[0]
            rows.append(("voice", lang, "*", name, alias, location))

    headers = ("TYPE", "LANG", "LOCAL", "NAME", "ALIASES", "LOCATION")
    col_widths = [len(h) + 1 for h in headers]
    for item in rows:
        for col, value in enumerate(item):
            col_widths[col] = max(col_widths[col], len(value) + 1)
    print(*(h.ljust(col_widths[col]) for col, h in enumerate(headers)))
    for item in sorted(rows):
        print(*(v.ljust(col_widths[col]) for col, v in enumerate(item)))


def get_args(argv: typing.Optional[typing.Sequence[str]] = None):
    parser = argparse.ArgumentParser(prog="larynx_tpu_torch")
    parser.add_argument("--language", help="Language for text input (en-us, etc.)")
    parser.add_argument("text", nargs="*", help="Text to convert to speech (default: stdin)")
    parser.add_argument(
        "--stdin-format",
        choices=[v.value for v in StdinFormat],
        default=StdinFormat.AUTO,
        help="Format of stdin text (default: auto)",
    )
    parser.add_argument(
        "--voice", "-v", default=None,
        help="Name of voice (expected in <voices-dir>/<language>; "
        "defaults to --language's default voice, else en-us)",
    )
    parser.add_argument(
        "--voices-dir",
        help="Directory with voices (format is <language>/<name_model-type>)",
    )
    parser.add_argument(
        "--quality", "-q",
        choices=["high", "medium", "low"],
        default="high",
        help="Vocoder quality (default: high)",
    )
    parser.add_argument("--list", action="store_true", help="List available voices/vocoders")
    parser.add_argument("--config", help="Path to JSON config with audio settings")
    parser.add_argument("--output-dir", help="Directory to write WAV file(s)")
    parser.add_argument(
        "--output-naming",
        choices=[v.value for v in OutputNaming],
        default="text",
        help="Naming scheme for output WAV files (requires --output-dir)",
    )
    parser.add_argument(
        "--id-delimiter", default="|",
        help="Delimiter between id and text in lines (default: |)",
    )
    parser.add_argument(
        "--interactive", action="store_true",
        help="Play audio after each input line (see --play-command)",
    )
    parser.add_argument("--csv", action="store_true", help="Input format is id|text")
    parser.add_argument(
        "--mark-file",
        help="File to write mark names to as they're encountered (--ssml only)",
    )
    parser.add_argument(
        "--noise-scale", type=float, default=0.667,
        help="Noise scale (default: 0.667, GlowTTS only)",
    )
    parser.add_argument(
        "--length-scale", type=float, default=1.0,
        help="Length scale (default: 1.0, GlowTTS only)",
    )
    parser.add_argument(
        "--denoiser-strength", type=float, default=0.005,
        help="Strength of denoiser, if available (default: 0.005)",
    )
    parser.add_argument(
        "--max-thread-workers", type=int,
        help="Accepted for compatibility; sentence batching replaces thread fan-out",
    )
    parser.add_argument(
        "--max-batch", type=int, default=8,
        help="Maximum sentences per batched call (default: 8)",
    )
    parser.add_argument(
        "--no-download", action="store_true",
        help="Don't automatically download voices or vocoders",
    )
    parser.add_argument(
        "--url-format", default=DEFAULT_VOICE_URL_FORMAT,
        help="Format string for download URLs (accepts {voice})",
    )
    parser.add_argument(
        "--play-command", default="play -",
        help="Shell command used to play audio interactively (default: play -)",
    )
    parser.add_argument(
        "--raw-stream", action="store_true",
        help="Stream raw 16-bit 22050Hz mono PCM audio to stdout",
    )
    parser.add_argument(
        "--stream", action="store_true",
        help="Chunked low-latency streaming: raw PCM flows after the first "
             "vocoder chunk instead of per sentence (fixed gain; implies "
             "--raw-stream output format)",
    )
    parser.add_argument(
        "--stream-chunk-frames", type=int, default=64,
        help="Mel frames per --stream chunk (default: 64, ~0.74s of audio)",
    )
    parser.add_argument(
        "--raw-stream-queue-size", default=5,
        help="Max sentences queued for output with --raw-stream (default: 5)",
    )
    parser.add_argument(
        "--process-on-blank-line", action="store_true",
        help="Process text only after encountering a blank line",
    )
    parser.add_argument(
        "--daemon", action="store_true",
        help="Connect to or run a background HTTP server for TTS (on --device, "
             "with --voices-dir and --half)",
    )
    parser.add_argument(
        "--daemon-port", type=int, default=15002,
        help="Port for the daemon HTTP server (default: 15002)",
    )
    parser.add_argument(
        "--stop-daemon", action="store_true",
        help="Try to stop the currently running daemon and exit",
    )
    parser.add_argument("--ssml", action="store_true", help="Input text is SSML")
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
        "--optimizations",
        choices=["auto", "on", "off"],
        default="auto",
        help="Accepted for compatibility",
    )
    parser.add_argument(
        "--backend",
        choices=[v.value for v in InferenceBackend],
        help="Checkpoint format preference (default: npz > pth > onnx)",
    )
    parser.add_argument("--seed", type=int, help="Set random seed (default: not set)")
    parser.add_argument("--version", action="store_true", help="Print version and exit")
    parser.add_argument(
        "--debug", action="store_true", help="Print DEBUG messages to the console"
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)

    if args.version:
        from larynx_tpu_torch import __version__

        print(__version__)
        sys.exit(0)

    if args.stop_daemon:
        _stop_daemon()
        sys.exit(0)

    if args.list:
        _list_voices_vocoders(get_voices_dirs(args.voices_dir))
        sys.exit(0)

    return args


if __name__ == "__main__":
    main()
