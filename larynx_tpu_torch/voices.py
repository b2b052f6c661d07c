# Copied from larynx_tpu/voices.py; only the package name in its imports differs.
"""Voice registry, name resolution, search paths, and downloading.

Functional replacement for ``larynx/utils.py`` + the ``VOICES`` /
``VOCODERS`` / ``VOICE_GENDERS`` data files.  The registry is embedded as
structured data: each entry is (language, voice name, gender, extra
aliases); the canonical resolved form is ``<lang>_<name>-<model_type>``
(name grammar: larynx/utils.py:82-88) which doubles as the release-tarball
basename (larynx/utils.py:19-21).
"""

import getpass
import logging
import os
import shutil
import tarfile
import tempfile
import typing
import urllib.request
from pathlib import Path
from urllib.error import HTTPError, URLError

_LOGGER = logging.getLogger("larynx_tpu.voices")

_ENV_VOICES_DIR = "LARYNX_VOICES_DIR"

DEFAULT_VOICE_URL_FORMAT = (
    "http://github.com/rhasspy/larynx/releases/download/v1.0/{voice}.tar.gz"
)

# Quality preset -> vocoder model dir (larynx/utils.py:27-31)
VOCODER_QUALITY: typing.Dict[str, str] = {
    "high": "hifi_gan/universal_large",
    "medium": "hifi_gan/vctk_medium",
    "low": "hifi_gan/vctk_small",
}

# Vocoder aliases (reference VOCODERS data file)
VOCODER_ALIASES: typing.Dict[str, str] = {
    "high": "hifi_gan-universal_large",
    "medium": "hifi_gan-vctk_medium",
    "low": "hifi_gan-vctk_small",
    "waveglow": "waveglow-wn_256",
}

# (lang, name, gender, extra aliases).  Model type is always glow_tts for
# released voices.  ``lang`` and bare ``name`` are aliases automatically;
# extra aliases cover the reference's language-default shorthands.
VOICE_REGISTRY: typing.Tuple[typing.Tuple[str, str, str, typing.Tuple[str, ...]], ...] = (
    ("de-de", "eva_k", "F", ()),
    ("de-de", "karlsson", "M", ()),
    ("de-de", "pavoque", "M", ()),
    ("de-de", "rebecca_braunert_plunkett", "F", ()),
    ("de-de", "thorsten", "M", ("de", "de-de")),
    ("de-de", "hokuspokus", "F", ()),
    ("de-de", "kerstin", "F", ()),
    ("en-us", "blizzard_fls", "F", ()),
    ("en-us", "blizzard_lessac", "F", ()),
    ("en-us", "cmu_aew", "M", ()),
    ("en-us", "cmu_ahw", "M", ()),
    ("en-us", "cmu_aup", "M", ()),
    ("en-us", "cmu_bdl", "M", ()),
    ("en-us", "cmu_clb", "F", ()),
    ("en-us", "cmu_eey", "F", ()),
    ("en-us", "cmu_fem", "M", ()),
    ("en-us", "cmu_jmk", "M", ()),
    ("en-us", "cmu_ksp", "M", ()),
    ("en-us", "cmu_ljm", "F", ()),
    ("en-us", "cmu_lnh", "F", ()),
    ("en-us", "cmu_rms", "M", ()),
    ("en-us", "cmu_rxr", "M", ()),
    ("en-us", "cmu_slp", "F", ()),
    ("en-us", "cmu_slt", "F", ()),
    ("en-us", "ek", "F", ()),
    ("en-us", "glados", "F", ()),
    ("en-us", "harvard", "F", ()),
    ("en-us", "judy_bieber", "F", ()),
    ("en-us", "kathleen", "F", ()),
    ("en-us", "ljspeech", "F", ()),
    ("en-us", "mary_ann", "F", ("en", "en-us")),
    ("en-us", "northern_english_male", "M", ()),
    ("en-us", "scottish_english_male", "M", ()),
    ("en-us", "southern_english_female", "F", ()),
    ("en-us", "southern_english_male", "M", ()),
    ("es-es", "carlfm", "M", ("es", "es-es")),
    ("es-es", "karen_savage", "F", ()),
    ("fr-fr", "gilles_le_blanc", "M", ()),
    ("fr-fr", "siwis", "F", ("fr", "fr-fr")),
    ("fr-fr", "tom", "M", ()),
    ("it-it", "lisa", "F", ("it", "it-it")),
    ("it-it", "riccardo_fasol", "M", ()),
    ("nl", "bart_de_leeuw", "M", ()),
    ("nl", "flemishguy", "M", ()),
    ("nl", "nathalie", "F", ()),
    ("nl", "rdh", "M", ("nl",)),
    ("ru-ru", "hajdurova", "F", ()),
    ("ru-ru", "minaev", "M", ()),
    ("ru-ru", "nikolaev", "M", ("ru", "ru-ru")),
    ("sv-se", "talesyntese", "M", ("sv", "sv-se")),
    ("sw", "biblia_takatifu", "M", ("sw",)),
)

MODEL_TYPE = "glow_tts"

# Built lazily: alias -> canonical "<lang>_<name>-glow_tts"
_VOICE_ALIASES: typing.Dict[str, str] = {}
VOICE_GENDERS: typing.Dict[str, str] = {}


def _build_aliases() -> None:
    if _VOICE_ALIASES:
        return
    for lang, name, gender, extras in VOICE_REGISTRY:
        canonical = f"{lang}_{name}-{MODEL_TYPE}"
        _VOICE_ALIASES[name] = canonical
        _VOICE_ALIASES[f"{name}-{MODEL_TYPE}"] = canonical
        _VOICE_ALIASES[canonical] = canonical
        for alias in extras:
            _VOICE_ALIASES[alias] = canonical
        VOICE_GENDERS[canonical] = gender


def resolve_voice_name(voice_name: str) -> str:
    """Alias -> canonical voice name (larynx/utils.py:76-79)."""
    _build_aliases()
    return _VOICE_ALIASES.get(voice_name, voice_name)


def split_voice_name(voice_name: str) -> typing.Tuple[str, str, str]:
    """``<lang>_<name>-<model_type>`` -> (lang, name, model_type).

    A name without an explicit model type ("de-de_thorsten") gets the
    default rather than silently losing its last character."""
    lang, rest = voice_name.split("_", maxsplit=1)
    last_dash = rest.rfind("-")
    if last_dash < 0:
        return lang, rest, MODEL_TYPE
    return lang, rest[:last_dash], rest[last_dash + 1 :]


def get_voice_download_name(voice_name: str) -> str:
    """Release tarball basename (canonical name doubles as it)."""
    return resolve_voice_name(voice_name)


def list_voices() -> typing.List[typing.Tuple[str, str, str]]:
    """[(canonical_name, lang, gender)] for every known voice."""
    _build_aliases()
    return [
        (f"{lang}_{name}-{MODEL_TYPE}", lang, gender)
        for lang, name, gender, _ in VOICE_REGISTRY
    ]


# -----------------------------------------------------------------------------


class VoiceDownloadError(Exception):
    """Raised when a voice or vocoder fails to download."""


def download_voice(
    voice_name: str, voices_dir: typing.Union[str, Path], link: str
) -> Path:
    """Download + extract a voice/vocoder tarball (layout:
    ``<lang>/<voice_dir>/`` inside the archive, larynx/utils.py:104-167)."""
    voices_dir = Path(voices_dir)
    voices_dir.mkdir(parents=True, exist_ok=True)
    _LOGGER.debug("Downloading %s to %s from %s", voice_name, voices_dir, link)

    try:
        with urllib.request.urlopen(link) as response:
            with tempfile.NamedTemporaryFile(mode="wb+", suffix=".tar.gz") as tmp:
                shutil.copyfileobj(response, tmp)
                tmp.seek(0)
                with tempfile.TemporaryDirectory() as tmp_dir:
                    with tarfile.open(tmp.name, "r:*") as tar:
                        tar.extractall(tmp_dir, filter="data")
                    tmp_path = Path(tmp_dir)
                    lang_dir = next(p for p in tmp_path.iterdir() if p.is_dir())
                    voice_dir = next(p for p in lang_dir.iterdir() if p.is_dir())

                    dest = voices_dir / lang_dir.name / voice_dir.name
                    dest.parent.mkdir(parents=True, exist_ok=True)
                    if dest.is_dir():
                        shutil.rmtree(dest)
                    shutil.move(str(voice_dir), str(dest))
                    return dest
    except (HTTPError, URLError, OSError) as e:
        raise VoiceDownloadError(
            f"Failed to download voice {voice_name} from {link}: {e}"
        ) from e


# -----------------------------------------------------------------------------


def get_voices_dirs(
    voices_dir: typing.Optional[typing.Union[str, Path]] = None
) -> typing.List[Path]:
    """Search-path chain (larynx/utils.py:173-200): explicit arg ->
    $LARYNX_VOICES_DIR -> XDG data dir -> ./local next to the package ->
    any extra dirs from $LARYNX_TPU_EXTRA_VOICES_DIRS (colon-separated;
    how deployments mount shared voice stores)."""
    dirs: typing.List[Path] = []
    if voices_dir:
        dirs.append(Path(voices_dir))

    env_dir = os.environ.get(_ENV_VOICES_DIR)
    if env_dir:
        dirs.append(Path(env_dir))

    data_home = os.environ.get("XDG_DATA_HOME")
    if data_home:
        dirs.append(Path(data_home) / "larynx" / "voices")
    else:
        dirs.append(Path.home() / ".local" / "share" / "larynx" / "voices")

    dirs.append(Path(__file__).parent.parent / "local")
    # system store the per-voice .debs install into
    # (scripts/build-debian-voice.sh), mirroring the reference's
    # /usr/lib/larynx-tts/local layout
    system_dir = Path("/usr/lib/larynx-tpu/voices")
    if system_dir.is_dir():
        dirs.append(system_dir)
    extra = os.environ.get("LARYNX_TPU_EXTRA_VOICES_DIRS", "")
    for part in extra.split(os.pathsep):
        if part and Path(part).is_dir():
            dirs.append(Path(part))
    return dirs


def valid_voice_dir(voice_dir: typing.Union[str, Path]) -> bool:
    """True if the dir holds a loadable checkpoint: .onnx, .pth, or our
    native .npz/orbax exports (superset of larynx/utils.py:203-209)."""
    voice_dir = Path(voice_dir)
    if not voice_dir.is_dir():
        return False
    for pattern in ("*.onnx", "*.pth", "*.pt", "*.npz", "*.msgpack"):
        if any(voice_dir.glob(pattern)):
            return True
    return False


def get_runtime_dir() -> Path:
    """XDG_RUNTIME_DIR/larynx or a per-user tempdir (larynx/utils.py:212-224)."""
    runtime = os.environ.get("XDG_RUNTIME_DIR")
    if runtime:
        path = Path(runtime) / "larynx"
    else:
        path = Path(tempfile.gettempdir()) / f"larynx-runtime-{getpass.getuser()}"
    path.mkdir(parents=True, exist_ok=True)
    return path
