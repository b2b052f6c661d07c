# Copied from larynx_tpu/text/types.py; only the package name in its imports differs.
"""Sentence/word structures produced by the text frontend.

API-compatible with the subset of gruut's objects the reference pipeline
consumes (larynx/__init__.py:71-177): per-sentence ``voice``/``lang``,
per-word ``phonemes``, SSML pause/mark attributes, iteration over words.
"""

import typing
from dataclasses import dataclass, field

MINOR_BREAK = "|"
MAJOR_BREAK = "‖"


@dataclass
class Word:
    """One token of a sentence (word, punctuation-break, or spelled item)."""

    text: str
    phonemes: typing.List[str] = field(default_factory=list)
    is_break: bool = False
    pause_before_ms: int = 0
    pause_after_ms: int = 0
    marks_before: typing.List[str] = field(default_factory=list)
    marks_after: typing.List[str] = field(default_factory=list)


@dataclass
class Sentence:
    """One sentence with per-word phonemes and SSML metadata."""

    text: str
    text_with_ws: str
    lang: str = ""
    voice: str = ""
    words: typing.List[Word] = field(default_factory=list)
    pause_before_ms: int = 0
    pause_after_ms: int = 0
    marks_before: typing.List[str] = field(default_factory=list)
    marks_after: typing.List[str] = field(default_factory=list)

    def __iter__(self) -> typing.Iterator[Word]:
        return iter(self.words)

    def __len__(self) -> int:
        return len(self.words)
