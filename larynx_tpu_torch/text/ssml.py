# Copied from larynx_tpu/text/ssml.py; only the package name in its imports differs.
"""SSML parsing into a flat event stream.

Covers the SSML subset the reference exercises through gruut
(larynx/__init__.py:71-177 and the web/MaryTTS surfaces): ``<speak>``,
``<voice name>``, ``<p>``, ``<s>``, ``<break time>``, ``<mark name>``,
``<sub alias>``, ``<say-as interpret-as>``, ``<phoneme ph>``, ``<w>``, and
``xml:lang`` / ``lang`` attributes.
"""

import re
import typing
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from larynx_tpu_torch.text.normalize import MONTH_NAMES as _MONTH_NAMES


@dataclass
class TextEvent:
    text: str
    voice: str = ""
    lang: str = ""
    spell_out: bool = False
    # active <lookup ref> inline lexicon: word -> {role: phonemes}
    lexicon: typing.Optional[dict] = None
    # inside <s>: automatic sentence re-splitting is disabled
    no_split: bool = False


@dataclass
class PhonemesEvent:
    """Explicit pronunciation from <phoneme ph="...">."""

    text: str
    phonemes: typing.List[str] = field(default_factory=list)
    voice: str = ""
    lang: str = ""


@dataclass
class BreakEvent:
    time_ms: int = 0


@dataclass
class MarkEvent:
    name: str = ""


@dataclass
class BoundaryEvent:
    """Forced sentence boundary (</s>, </p>, voice scope edge)."""


Event = typing.Union[TextEvent, PhonemesEvent, BreakEvent, MarkEvent, BoundaryEvent]

_TIME_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s)?\s*$")


def parse_time_ms(value: typing.Optional[str]) -> int:
    if not value:
        return 0
    m = _TIME_RE.match(value)
    if not m:
        return 0
    amount = float(m.group(1))
    # SSML requires a unit; treat a bare number as milliseconds — reading
    # time="500" as 500 SECONDS would emit minutes of silence
    unit = m.group(2) or "ms"
    return int(amount * 1000) if unit == "s" else int(amount)


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1].lower()


def _attr(elem: ET.Element, *names: str) -> typing.Optional[str]:
    for key, value in elem.attrib.items():
        if _strip_ns(key) in names:
            return value
    return None


def parse_ssml(markup: str, default_lang: str = "") -> typing.List[Event]:
    """Parse SSML (or a bare fragment) into an event stream.

    ``default_lang`` is the document language when no xml:lang overrides
    it — <say-as> date/number expansion is language-dependent.
    """
    markup = markup.strip()
    if not markup.startswith("<"):
        markup = f"<speak>{markup}</speak>"
    try:
        root = ET.fromstring(markup)
    except ET.ParseError:
        root = ET.fromstring(f"<speak>{markup}</speak>")

    lexicons = _collect_lexicons(root)
    events: typing.List[Event] = []
    # an id-less <lexicon> is active document-wide without <lookup>
    _walk(
        root, "", default_lang, False, lexicons.get(""), lexicons, events
    )
    return events


# An inline lexicon maps word -> {role: phonemes}; "" is the role-less
# default entry.
Lexicon = typing.Dict[str, typing.Dict[str, typing.List[str]]]


def _collect_lexicons(root: ET.Element) -> typing.Dict[str, Lexicon]:
    """Gather <lexicon id> inline pronunciation lexicons.

    Reference contract (README "SSML"): one or more <lexeme> children,
    each with <grapheme role=...> word text and <phoneme>
    whitespace-separated phonemes.  An id-less <lexicon> becomes the
    DOCUMENT lexicon (key ""), active without any <lookup> — gruut's
    "override the pronunciation of any word in the document".
    """
    out: typing.Dict[str, Lexicon] = {}
    for elem in root.iter():
        if _strip_ns(elem.tag) != "lexicon":
            continue
        lex_id = _attr(elem, "id") or ""
        entries = out.setdefault(lex_id, {})
        for lexeme in elem:
            if _strip_ns(lexeme.tag) != "lexeme":
                continue
            graphemes: typing.List[typing.Tuple[str, str]] = []
            phonemes: typing.List[str] = []
            for child in lexeme:
                ctag = _strip_ns(child.tag)
                ctext = "".join(child.itertext()).strip()
                if ctag == "grapheme" and ctext:
                    graphemes.append(
                        (ctext.lower(), _attr(child, "role") or "")
                    )
                elif ctag == "phoneme" and ctext:
                    phonemes = ctext.split()
            for g, role in graphemes:
                if phonemes:
                    entries.setdefault(g, {})[role] = phonemes
    return out


def _emit_text(
    events: typing.List[Event],
    text: typing.Optional[str],
    voice,
    lang,
    spell,
    lexicon=None,
    no_split=False,
):
    if text and text.strip():
        events.append(
            TextEvent(
                text=text, voice=voice, lang=lang, spell_out=spell,
                lexicon=lexicon, no_split=no_split,
            )
        )


def _walk(
    elem: ET.Element,
    voice: str,
    lang: str,
    spell_out: bool,
    lookup: typing.Optional[Lexicon],
    lexicons: typing.Dict[str, Lexicon],
    events: typing.List[Event],
    no_split: bool = False,
) -> None:
    tag = _strip_ns(elem.tag)

    elem_lang = _attr(elem, "lang") or lang
    if tag == "speak":
        lang = elem_lang
    elif tag == "voice":
        voice = _attr(elem, "name") or voice
        lang = elem_lang
    elif tag in ("p", "s"):
        events.append(BoundaryEvent())
        lang = elem_lang
        if tag == "s":
            no_split = True  # <s> content stays ONE sentence
    elif tag == "break":
        events.append(BreakEvent(parse_time_ms(_attr(elem, "time"))))
        return
    elif tag == "mark":
        events.append(MarkEvent(_attr(elem, "name") or ""))
        return
    elif tag == "sub":
        alias = _attr(elem, "alias") or ""
        _emit_text(events, alias, voice, elem_lang, spell_out, lookup)
        return
    elif tag == "phoneme":
        ph = _attr(elem, "ph") or ""
        word_text = "".join(elem.itertext()).strip()
        events.append(
            PhonemesEvent(
                text=word_text or ph,
                phonemes=ph.split() if " " in ph else list(_split_ipa(ph)),
                voice=voice,
                lang=elem_lang,
            )
        )
        return
    elif tag == "lexicon":
        return  # consumed by _collect_lexicons
    elif tag == "lookup":
        ref = _attr(elem, "ref") or ""
        lookup = lexicons.get(ref, lookup)
    elif tag == "say-as":
        interpret = (_attr(elem, "interpret-as") or "").lower()
        fmt = (_attr(elem, "format") or "").lower()
        inner = "".join(elem.itertext())
        if interpret in ("digits", "telephone") or (
            interpret == "number" and fmt == "digits"
        ):
            # each digit becomes its own number word (4 2 -> four two)
            inner = re.sub(r"\d", lambda m: m.group() + " ", inner)
            _emit_text(events, inner, voice, elem_lang, False, lookup)
            return
        spell = interpret in ("characters", "spell-out")
        if not spell:
            inner = _interpret_text(inner, interpret, fmt, elem_lang)
        _emit_text(events, inner, voice, elem_lang, spell, lookup)
        return
    elif tag == "w":
        lang = elem_lang
        role = _attr(elem, "role") or ""
        if role:
            word_text = "".join(elem.itertext()).strip()
            if role == "gruut:letter":
                _emit_text(events, word_text, voice, lang, True, lookup)
                return
            entry = (lookup or {}).get(word_text.lower(), {})
            phones = entry.get(role)
            if phones:
                events.append(
                    PhonemesEvent(
                        text=word_text,
                        phonemes=list(phones),
                        voice=voice,
                        lang=lang,
                    )
                )
                return

    _emit_text(
        events, elem.text, voice, lang, spell_out, lookup, no_split
    )
    for child in elem:
        _walk(
            child, voice, lang, spell_out, lookup, lexicons, events,
            no_split,
        )
        _emit_text(
            events, child.tail, voice, lang, spell_out, lookup, no_split
        )

    if tag in ("p", "s"):
        events.append(BoundaryEvent())
    elif tag == "voice":
        events.append(BoundaryEvent())


_NUMBER_TOKEN_RE = re.compile(r"\d+")


def _interpret_text(
    text: str, interpret: str, fmt: str, lang: str
) -> str:
    """Rewrite <say-as> content using the interpretation markers the
    normalizer understands (N_cardinal / N_ordinal / N_year — the same
    convention gruut accepts in plain text, pinned by the en-us
    reference fixtures' test_sentences.txt)."""
    from larynx_tpu_torch.text.langs import resolve_lang

    lang = resolve_lang(lang) if lang else "en-us"
    if interpret in ("number", "cardinal", "ordinal"):
        kind = "ordinal" if (interpret == "ordinal" or fmt == "ordinal") \
            else ("year" if fmt == "year" else "cardinal")
        return _NUMBER_TOKEN_RE.sub(lambda m: f"{m.group()}_{kind}", text)
    if interpret == "date":
        return _expand_date(text.strip(), fmt, lang)
    # time / currency: the plain tokenizer+normalizer already read
    # h:mm clocks and $/€/£ amounts
    return text


def _expand_date(text: str, fmt: str, lang: str) -> str:
    """Spoken form of a numeric date per the reference's format chars:
    d cardinal day, o ordinal day, m month name, y year."""
    parts = [p for p in re.split(r"[./\-\s]+", text) if p.isdigit()]
    if not (2 <= len(parts) <= 3):
        return text
    # digit order: en-us writes m/d/y, the other languages d/m/y;
    # a leading 4-digit field is ISO y-m-d
    year = None
    if len(parts) == 3 and len(parts[0]) == 4:
        year, month, day = parts[0], parts[1], parts[2]
    elif lang == "en-us":
        month, day = parts[0], parts[1]
        year = parts[2] if len(parts) == 3 else None
    else:
        day, month = parts[0], parts[1]
        year = parts[2] if len(parts) == 3 else None
    if not fmt:
        fmt = "moy" if lang == "en-us" else "omy"
    months = _MONTH_NAMES.get(lang, _MONTH_NAMES["en-us"])
    month_name = months[(int(month) - 1) % 12]
    out: typing.List[str] = []
    for ch in fmt:
        if ch == "m":
            out.append(month_name)
        elif ch == "d":
            out.append(f"{int(day)}_cardinal")
        elif ch == "o":
            out.append(f"{int(day)}_ordinal")
        elif ch == "y" and year is not None:
            out.append(f"{int(year)}_year")
    return " ".join(out) if out else text


_IPA_MODIFIERS = "ˈˌːʲ̯͡ ²'"


def _split_ipa(ph: str) -> typing.List[str]:
    """Split an unspaced IPA string into symbols (greedy, keeps ties)."""
    out: typing.List[str] = []
    i = 0
    while i < len(ph):
        ch = ph[i]
        if ch == " ":
            i += 1
            continue
        symbol = ch
        i += 1
        # attach combining marks / tie bars and the tied symbol
        while i < len(ph) and (ph[i] in "ː̯ʲ̃" or ph[i] == "͡"):
            if ph[i] == "͡" and i + 1 < len(ph):
                symbol += ph[i] + ph[i + 1]
                i += 2
            else:
                symbol += ph[i]
                i += 1
        if ch in "ˈˌ" and i < len(ph):
            # stress marker binds to the following symbol
            nxt = _split_ipa(ph[i:])
            if nxt:
                nxt[0] = symbol + nxt[0]
                return out + nxt
        out.append(symbol)
    return out
