# Copied from larynx_tpu/text/frontend.py; only the package name in its imports differs.
"""Text frontend orchestration: ``sentences()`` — the gruut replacement.

Produces :class:`~larynx_tpu.text.types.Sentence` objects with per-word IPA
phonemes, SSML pauses and marks — the exact structure the pipeline consumes
(reference usage: larynx/__init__.py:71-177).
"""

import typing

from larynx_tpu_torch.text import ssml as ssml_mod
from larynx_tpu_torch.text.g2p import get_phonemizer
from larynx_tpu_torch.text.langs import resolve_lang
from larynx_tpu_torch.text.tokenize import split_sentences, words_of
from larynx_tpu_torch.text.types import MAJOR_BREAK, MINOR_BREAK, Sentence, Word


def _phonemize_words(
    kinds_tokens: typing.Sequence[typing.Tuple[str, str]],
    lang: str,
    spell_out: bool = False,
    ssml_lexicon: typing.Optional[
        typing.Dict[str, typing.List[str]]
    ] = None,
) -> typing.List[Word]:
    phonemize = get_phonemizer(lang)
    context_aware = getattr(phonemize, "context_aware", False)
    word_tokens = [t for k, t in kinds_tokens if k == "word"]
    # full token stream (breaks as their punctuation text) for
    # clause-window homograph cues
    ctx_tokens = [t for _, t in kinds_tokens]
    words: typing.List[Word] = []
    word_idx = 0
    for pos, (kind, token) in enumerate(kinds_tokens):
        if kind == "minor":
            words.append(Word(text=token, phonemes=[MINOR_BREAK], is_break=True))
        elif kind == "major":
            words.append(Word(text=token, phonemes=[MAJOR_BREAK], is_break=True))
        elif ssml_lexicon and token.lower() in ssml_lexicon:
            # inline <lexicon>/<lookup> pronunciation wins over G2P;
            # the role-less entry is the default (roles select via
            # <w role> in ssml.py)
            entry = ssml_lexicon[token.lower()]
            phones = entry.get("") or next(iter(entry.values()))
            words.append(Word(text=token, phonemes=list(phones)))
            word_idx += 1
        elif spell_out:
            # letter-name spelling (the gruut:letter role: "a" is /eɪ/,
            # not the article)
            names = getattr(phonemize, "letter_names", None)
            for ch in token:
                phonemes = (names or {}).get(ch.lower()) or phonemize(ch)
                if phonemes:
                    words.append(Word(text=ch, phonemes=list(phonemes)))
            word_idx += 1
        else:
            if context_aware:
                # neighboring words drive homograph disambiguation
                prev = word_tokens[word_idx - 1] if word_idx > 0 else ""
                nxt = (
                    word_tokens[word_idx + 1]
                    if word_idx + 1 < len(word_tokens)
                    else ""
                )
                phonemes = phonemize(
                    token, prev=prev, nxt=nxt,
                    context=ctx_tokens, index=pos,
                )
            else:
                phonemes = phonemize(token)
            if phonemes:
                words.append(Word(text=token, phonemes=phonemes))
            word_idx += 1
    return words


def _plain_sentences(text: str, lang: str) -> typing.Iterator[Sentence]:
    for raw in split_sentences(text, lang):
        words = _phonemize_words(words_of(raw, lang), lang)
        if not words:
            continue
        # NO trailing break is synthesized: a sentence ends with ‖ only when
        # the text carries final punctuation (the ru-ru golden fixtures have
        # unpunctuated sentences with no trailing ‖)
        yield Sentence(
            text=raw, text_with_ws=raw + " ", lang=lang, words=words
        )


def sentences(
    text: str,
    lang: str = "en-us",
    ssml: bool = False,
    explicit_lang: bool = False,
    **_kwargs,
) -> typing.Iterator[Sentence]:
    """Segment + normalize + phonemize text (gruut.sentences equivalent).

    With ``ssml=True`` the input is parsed as SSML: per-sentence voice/lang
    switching, <break> pauses, and <mark> names are attached to sentences
    (reference consumption: larynx/__init__.py:74-177).
    """
    lang = resolve_lang(lang)
    if not ssml:
        yield from _plain_sentences(text, lang)
        return

    # SSML path is materialized up front: trailing <break>/<mark> events
    # mutate already-built sentences (pause_after/marks_after), so laziness
    # would leak half-attached metadata to the consumer.
    yield from _ssml_sentences(text, lang)


def _ssml_sentences(text: str, lang: str) -> typing.List[Sentence]:
    events = ssml_mod.parse_ssml(text, default_lang=lang)

    # Group events into segments at boundaries/voice changes, accumulating
    # pending pauses/marks that attach to the next (or previous) sentence.
    pending_pause_ms = 0
    pending_marks: typing.List[str] = []
    last_sentence: typing.Optional[Sentence] = None

    # ordered segment contents: text chunks interleaved with explicit
    # <phoneme> Words — order matters ("I say <phoneme...> loudly" must
    # not move the phoneme word to the segment end)
    # text items carry their own <lookup> lexicon and spell-out flag
    # so a scope change mid-sentence does not force a sentence split
    segment_items: typing.List[
        typing.Union[
            typing.Tuple[str, typing.Optional[dict], bool], Word
        ]
    ] = []
    segment_voice = ""
    segment_lang = lang

    def segment_nonempty() -> bool:
        return any(
            isinstance(it, Word) or it[0].strip() for it in segment_items
        )

    def flush() -> typing.Iterator[Sentence]:
        nonlocal segment_items, pending_pause_ms, pending_marks, last_sentence
        items = segment_items
        segment_items = []
        if not any(isinstance(it, Word) or it[0].strip() for it in items):
            return
        seg_lang = resolve_lang(segment_lang) if segment_lang else lang

        # Walk the items in order, closing a sentence whenever a text
        # chunk completes one; a <phoneme> Word joins the open sentence.
        open_words: typing.List[Word] = []
        open_text: typing.List[str] = []
        closed: typing.List[typing.Tuple[str, typing.List[Word]]] = []

        def close() -> None:
            if open_words:
                raw = " ".join(t for t in open_text if t).strip()
                closed.append((raw, list(open_words)))
            open_words.clear()
            open_text.clear()

        for item in items:
            if isinstance(item, Word):
                open_words.append(item)
                open_text.append(item.text)
                continue
            chunk, chunk_lexicon, chunk_spell, chunk_no_split = item
            if not chunk.strip():
                continue
            raws = (
                [chunk.strip()]
                if chunk_no_split
                else split_sentences(chunk, seg_lang)
            )
            for i, raw in enumerate(raws):
                open_words.extend(
                    _phonemize_words(
                        words_of(raw, seg_lang),
                        seg_lang,
                        chunk_spell,
                        chunk_lexicon,
                    )
                )
                open_text.append(raw)
                if not chunk_no_split and (
                    i < len(raws) - 1 or raw.rstrip()[-1:] in ".!?…。"
                ):
                    close()  # chunk completed this sentence
        close()

        for raw, words in closed:
            sent = Sentence(
                text=raw,
                text_with_ws=raw + " ",
                lang=seg_lang,
                voice=segment_voice,
                words=words,
            )
            if pending_pause_ms > 0:
                sent.pause_before_ms = pending_pause_ms
                pending_pause_ms = 0
            if pending_marks:
                sent.marks_before = list(pending_marks)
                pending_marks = []
            last_sentence = sent
            yield sent

    out: typing.List[Sentence] = []
    for event in events:
        if isinstance(event, ssml_mod.TextEvent):
            if (
                event.voice != segment_voice
                or (event.lang or lang) != segment_lang
            ) and segment_nonempty():
                out.extend(flush())
            segment_voice = event.voice
            segment_lang = event.lang or lang
            segment_items.append(
                (event.text, event.lexicon, event.spell_out,
                 event.no_split)
            )
        elif isinstance(event, ssml_mod.PhonemesEvent):
            segment_voice = event.voice or segment_voice
            segment_lang = event.lang or segment_lang
            segment_items.append(
                Word(text=event.text, phonemes=list(event.phonemes))
            )
        elif isinstance(event, ssml_mod.BreakEvent):
            if segment_nonempty():
                out.extend(flush())
            # A pause between sentences attaches to the following sentence
            # (pause_before); the reference sums sentence + word pauses
            # (larynx/__init__.py:135-143).
            pending_pause_ms += event.time_ms
        elif isinstance(event, ssml_mod.MarkEvent):
            if segment_nonempty():
                out.extend(flush())
            if last_sentence is not None:
                last_sentence.marks_after.append(event.name)
            else:
                pending_marks.append(event.name)
        elif isinstance(event, ssml_mod.BoundaryEvent):
            if segment_nonempty():
                out.extend(flush())

    out.extend(flush())
    # trailing <break> with no following sentence: attach to the last one
    if pending_pause_ms > 0 and out:
        out[-1].pause_after_ms += pending_pause_ms
    return out
