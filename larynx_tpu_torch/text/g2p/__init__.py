# Copied from larynx_tpu/text/g2p/__init__.py; only the package name in its imports differs.
"""Grapheme-to-phoneme conversion, per language.

Self-contained replacement for gruut's lexicon+model phonemizers (the
reference delegates all phonemization to the external gruut dependency).
Each language module exposes ``phonemize(word) -> List[str]`` returning IPA
symbols drawn from that language's voice inventory
(``local/<lang>/<voice>/phonemes.txt`` in the reference).

English combines an embedded lexicon with letter-to-sound rules; the other
languages use orthography rules (Spanish/Italian/Swahili/Russian are largely
phonemic scripts; German/French/Dutch/Swedish are best-effort rules).
"""

import typing


class Phonemizer(typing.Protocol):
    def __call__(self, word: str) -> typing.List[str]: ...


_CACHE: typing.Dict[str, Phonemizer] = {}


def get_phonemizer(lang: str) -> Phonemizer:
    """Return the phonemizer for a canonical language code."""
    if lang in _CACHE:
        return _CACHE[lang]

    if lang == "en-us":
        from larynx_tpu_torch.text.g2p import en as mod
    elif lang == "de-de":
        from larynx_tpu_torch.text.g2p import de as mod
    elif lang == "es-es":
        from larynx_tpu_torch.text.g2p import es as mod
    elif lang == "fr-fr":
        from larynx_tpu_torch.text.g2p import fr as mod
    elif lang == "it-it":
        from larynx_tpu_torch.text.g2p import it as mod
    elif lang == "nl":
        from larynx_tpu_torch.text.g2p import nl as mod
    elif lang == "ru-ru":
        from larynx_tpu_torch.text.g2p import ru as mod
    elif lang == "sv-se":
        from larynx_tpu_torch.text.g2p import sv as mod
    elif lang == "sw":
        from larynx_tpu_torch.text.g2p import sw as mod
    else:
        from larynx_tpu_torch.text.g2p import en as mod  # fallback

    from larynx_tpu_torch.text.g2p.lexicons import LEXICONS

    lexicon = LEXICONS.get(lang)
    base = mod.phonemize
    letter_names = getattr(mod, "_LETTER_NAMES", None)
    base_ctx = getattr(base, "context_aware", False)
    if lexicon:

        sandhi_words = getattr(base, "sandhi_words", frozenset())

        def phonemize(
            word: str,
            prev: str = "",
            nxt: str = "",
            context: typing.Optional[typing.Sequence[str]] = None,
            index: int = -1,
        ) -> typing.List[str]:
            w = word.lower().strip()
            # context-dependent words (liaison) bypass the static lexicon
            if w not in sandhi_words:
                hit = lexicon.get(w)
                if hit is not None:
                    return list(hit)
            if base_ctx:
                return base(word, prev=prev, nxt=nxt,
                            context=context, index=index)
            return base(word)

        phonemize.context_aware = True
    else:
        phonemize = base

    if letter_names is not None:
        phonemize.letter_names = letter_names  # type: ignore[attr-defined]
    _CACHE[lang] = phonemize
    return phonemize
