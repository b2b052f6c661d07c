# Copied from larynx_tpu/text/langs.py; only the package name in its imports differs.
"""Language code resolution (gruut.resolve_lang equivalent)."""

import typing

# Canonical languages with shipped voices (larynx/VOICES registry)
KNOWN_LANGS = (
    "de-de",
    "en-us",
    "es-es",
    "fr-fr",
    "it-it",
    "nl",
    "ru-ru",
    "sv-se",
    "sw",
)

_ALIASES = {
    "de": "de-de",
    "en": "en-us",
    "en-gb": "en-us",
    "es": "es-es",
    "fr": "fr-fr",
    "it": "it-it",
    "nl-nl": "nl",
    "ru": "ru-ru",
    "sv": "sv-se",
    "sw-ke": "sw",
    "sw-tz": "sw",
}


def resolve_lang(lang: typing.Optional[str]) -> str:
    """Normalize a language tag to a canonical voice language."""
    if not lang:
        return "en-us"
    tag = lang.strip().lower().replace("_", "-")
    if tag in KNOWN_LANGS:
        return tag
    if tag in _ALIASES:
        return _ALIASES[tag]
    base = tag.split("-")[0]
    if base in KNOWN_LANGS:
        return base
    if base in _ALIASES:
        return _ALIASES[base]
    for known in KNOWN_LANGS:
        if known.startswith(base):
            return known
    return tag
