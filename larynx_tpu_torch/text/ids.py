# Copied from larynx_tpu/text/ids.py; only the package name in its imports differs.
"""Phoneme -> id mapping.

Self-contained replacement for the external ``phonemes2ids`` dependency used
by the reference pipeline (larynx/__init__.py:123-130 calls it with
``pad="_"``, ``blank="#"``, ``separate={"ˈ", "ˌ", "²"}``,
``simple_punctuation=True``).  Semantics were pinned against the golden
fixtures shipped with the reference voices
(``local/<lang>/<voice>/samples/test_phonemes.csv``):

  * the id table comes from the voice's ``phonemes.txt`` (``<id> <phoneme>``
    per line)
  * stress/tone markers listed in ``separate`` are split off the front of a
    phoneme into their own symbol
  * ``simple_punctuation`` folds raw punctuation into the minor/major break
    symbols ``|`` / ``‖``
  * a ``blank`` symbol is inserted before every word (and therefore between
    words); no trailing blank after the final word
  * unknown phonemes are dropped (logged at debug level)
"""

import logging
import typing
import unicodedata

_LOGGER = logging.getLogger("larynx_tpu.text.ids")

DEFAULT_PAD = "_"
DEFAULT_BLANK = "#"
MINOR_BREAK = "|"
MAJOR_BREAK = "‖"

# Stress / tone markers that become standalone symbols
DEFAULT_SEPARATE = frozenset({"ˈ", "ˌ", "²"})

# simple_punctuation folding: everything short-pause-like -> "|",
# sentence-final-like -> "‖"
SIMPLE_PUNCTUATION = {
    ",": MINOR_BREAK,
    ";": MINOR_BREAK,
    ":": MINOR_BREAK,
    "-": MINOR_BREAK,
    "—": MINOR_BREAK,
    "(": MINOR_BREAK,
    ")": MINOR_BREAK,
    "[": MINOR_BREAK,
    "]": MINOR_BREAK,
    "…": MINOR_BREAK,
    "、": MINOR_BREAK,
    ".": MAJOR_BREAK,
    "!": MAJOR_BREAK,
    "?": MAJOR_BREAK,
    "。": MAJOR_BREAK,
    "¡": MAJOR_BREAK,
    "¿": MAJOR_BREAK,
}


def load_phoneme_ids(fileobj: typing.TextIO) -> typing.Dict[str, int]:
    """Parse a ``phonemes.txt`` (``<id> <phoneme>`` per line) into a dict.

    Blank lines and ``#``-comment lines are skipped, except a line whose
    *symbol* is ``#`` itself (the blank token) which must survive.
    """
    phoneme_to_id: typing.Dict[str, int] = {}
    for line in fileobj:
        line = line.strip("\r\n")
        if not line.strip():
            continue
        parts = line.split(" ", maxsplit=1)
        if len(parts) != 2:
            continue
        id_str, phoneme = parts
        try:
            pid = int(id_str)
        except ValueError:
            continue
        # keep leading/trailing whitespace out but preserve the symbol itself
        phoneme = phoneme.strip() or " "
        phoneme_to_id[phoneme] = pid
    return phoneme_to_id


def _split_separate(
    phoneme: str, separate: typing.FrozenSet[str]
) -> typing.List[str]:
    """Split leading markers (e.g. ``ˈaɪ`` -> [``ˈ``, ``aɪ``])."""
    out: typing.List[str] = []
    rest = phoneme
    while rest and rest[0] in separate:
        out.append(rest[0])
        rest = rest[1:]
    # trailing tone markers (e.g. Swedish accent "²" may be suffixed)
    tail: typing.List[str] = []
    while rest and rest[-1] in separate:
        tail.append(rest[-1])
        rest = rest[:-1]
    if rest:
        out.append(rest)
    out.extend(reversed(tail))
    return out


def phonemes_to_ids(
    word_phonemes: typing.Sequence[typing.Sequence[str]],
    phoneme_to_id: typing.Mapping[str, int],
    pad: str = DEFAULT_PAD,
    blank: typing.Optional[str] = DEFAULT_BLANK,
    separate: typing.Iterable[str] = DEFAULT_SEPARATE,
    simple_punctuation: bool = True,
) -> typing.List[int]:
    """Convert per-word phoneme lists into a flat id sequence.

    Mirrors the call contract at larynx/__init__.py:123-130.
    """
    separate_set = frozenset(separate)
    blank_id: typing.Optional[int] = None
    if blank is not None:
        blank_id = phoneme_to_id.get(blank)

    ids: typing.List[int] = []
    prev_was_major_break = False
    for word in word_phonemes:
        if not word:
            continue
        # Blank precedes every word EXCEPT one directly following a major
        # break — pinned against the multi-sentence golden fixtures
        # (e.g. ljspeech samples/test_phonemes.csv: "... # ‖ ˈaɪ m # ...").
        if blank_id is not None and not prev_was_major_break:
            ids.append(blank_id)
        prev_was_major_break = word[-1] == MAJOR_BREAK or (
            simple_punctuation
            and SIMPLE_PUNCTUATION.get(word[-1]) == MAJOR_BREAK
        )
        for phoneme in word:
            if not phoneme:
                continue
            phoneme = unicodedata.normalize("NFC", phoneme)
            if simple_punctuation:
                phoneme = SIMPLE_PUNCTUATION.get(phoneme, phoneme)
            for symbol in _split_separate(phoneme, separate_set):
                symbol_id = phoneme_to_id.get(symbol)
                if symbol_id is None and simple_punctuation:
                    folded = SIMPLE_PUNCTUATION.get(symbol)
                    if folded is not None:
                        symbol_id = phoneme_to_id.get(folded)
                if symbol_id is None:
                    _LOGGER.debug("Dropping unknown phoneme: %r", symbol)
                    continue
                ids.append(symbol_id)
    # A trailing blank closes the sequence unless it already ends on a
    # major break (ru-ru golden fixtures: unpunctuated sentences end
    # "... u ɡ rʲ eː j #" — blank, no ‖).
    if blank_id is not None and ids and not prev_was_major_break:
        ids.append(blank_id)
    return ids
