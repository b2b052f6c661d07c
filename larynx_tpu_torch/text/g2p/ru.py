# Copied from larynx_tpu/text/g2p/ru.py; only the package name in its imports differs.
"""Russian G2P — Cyrillic segment mapping + lexical stress system.

Segment style follows the gruut lexicon entries pinned by the golden
fixtures (local/ru-ru/*/samples/test_phonemes.csv): orthographic vowel
quality (no akanye — unstressed ``о`` stays ``o``, matching "говорите"
-> ``ɡ o v o rʲ iː tʲ e``), palatalized consonants before soft vowels/ь,
and STRESS ENCODED AS VOWEL LENGTH (the ru-ru voice inventory has no
ə/ɐ/stress marks; ``aː`` vs ``a`` is the stress contrast the voices
were trained on).

Stress placement — the part the reference delegated to gruut's
full lexicon — comes from a layered system (see ru_stress.py for the
data):

1. ``ё`` is inherently stressed.
2. Exact-form lexicon (mobile-stress forms enumerated: "гОлову" vs
   "головА").
3. Stem lexicon via ending stripping: fixed-stress stems carry their
   stressed vowel; end-stressed stems (язык-, говор-) stress the first
   ending vowel, falling back to the last stem vowel for bare forms
   ("язы́к" vs "языкА́", "говорИт"/"говорИли").
4. Derivational suffix rules (-ение/-ание/-ация antepenult-of-suffix,
   -изм/-ист final, ...).
5. Defaults: monosyllables are stressed unless clitics (бы/не/ли/же...,
   matching the fixtures' unstressed "бы" but stressed "вы"/"на");
   polysyllables default to the penult.
"""

import typing

from larynx_tpu_torch.text.g2p.ru_stress import stress_index
from larynx_tpu_torch.text.g2p.rules import spell_letters

_SOFT_VOWELS = {"е": "e", "ё": "o", "ю": "u", "я": "a", "и": "i"}
_HARD_VOWELS = {"а": "a", "э": "e", "о": "o", "у": "u", "ы": "ɨ"}
_PAIRED = {
    "б": "b", "в": "v", "г": "ɡ", "д": "d", "з": "z", "к": "k", "л": "l",
    "м": "m", "н": "n", "п": "p", "р": "r", "с": "s", "т": "t", "ф": "f",
    "х": "x",
}
_UNPAIRED = {
    "ж": "ʐ", "ш": "ʂ", "ц": "t͡s", "ч": "t͡ɕ", "щ": "ɕː", "й": "j",
}
_VOWEL_SYMBOLS = {"a", "e", "i", "o", "u", "ɨ"}
# always-hard consonants: a following и is phonetically [ɨ] (жи/ши/ци)
_ALWAYS_HARD = {"ж", "ш", "ц"}


def _segments(w: str) -> typing.List[str]:
    """Cyrillic -> unstressed phoneme list (palatalization resolved)."""
    out: typing.List[str] = []
    i = 0
    n = len(w)
    while i < n:
        ch = w[i]
        nxt = w[i + 1] if i + 1 < n else ""
        if ch in _PAIRED:
            cons = _PAIRED[ch]
            if nxt in _SOFT_VOWELS or nxt == "ь":
                cons += "ʲ"
            out.append(cons)
            i += 1
            continue
        if ch in _UNPAIRED:
            out.append(_UNPAIRED[ch])
            i += 1
            continue
        if ch in _HARD_VOWELS:
            out.append(_HARD_VOWELS[ch])
            i += 1
            continue
        if ch in _SOFT_VOWELS:
            vowel = _SOFT_VOWELS[ch]
            prev = w[i - 1] if i > 0 else ""
            if ch == "и" and prev in _ALWAYS_HARD:
                out.append("ɨ")
                i += 1
                continue
            # word-initial / post-vowel / post-sign soft vowels get a
            # glide; и only after the soft sign (семьи [sʲemʲji])
            if (
                ch != "и"
                and (i == 0 or prev in "аэоуыеёюяи" or prev in "ьъ")
            ) or (ch == "и" and prev == "ь"):
                out.append("j")
            out.append(vowel)
            i += 1
            continue
        # ь palatalizes the previous consonant (already handled); ъ separates
        i += 1
    return out


# Irregular segmental forms the letter mapping cannot produce: что-
# class ч->[ʂ], чн->[ʂn] in конечно, and the standard silent clusters
# of the highest-frequency words (здравствуйте, солнце, праздник).
_SEGMENT_EXCEPTIONS: typing.Dict[str, typing.List[str]] = {
    "что": ["ʂ", "t", "oː"],
    "чтобы": ["ʂ", "t", "oː", "b", "ɨ"],
    "что-то": ["ʂ", "t", "oː", "t", "o"],
    "ничто": ["nʲ", "i", "ʂ", "t", "oː"],
    "конечно": ["k", "o", "nʲ", "eː", "ʂ", "n", "o"],
    "скучно": ["s", "k", "uː", "ʂ", "n", "o"],
    "здравствуйте": ["z", "d", "r", "aː", "s", "t", "v", "u", "j",
                     "tʲ", "e"],
    "здравствуй": ["z", "d", "r", "aː", "s", "t", "v", "u", "j"],
    "солнце": ["s", "oː", "n", "t͡s", "e"],
    "сердце": ["sʲ", "eː", "r", "t͡s", "e"],
    "праздник": ["p", "r", "aː", "z", "nʲ", "i", "k"],
    "праздники": ["p", "r", "aː", "z", "nʲ", "i", "kʲ", "i"],
    "счастье": ["ɕː", "aː", "s", "tʲ", "j", "e"],
    "счастлив": ["ɕː", "aː", "s", "lʲ", "i", "f"],
    "счастлива": ["ɕː", "aː", "s", "lʲ", "i", "v", "a"],
    # сч/жч = [ɕː] (счёт, считать, мужчина)
    "счёт": ["ɕː", "oː", "t"],
    "счёта": ["ɕː", "oː", "t", "a"],
    "считать": ["ɕː", "i", "t", "aː", "tʲ"],
    "считает": ["ɕː", "i", "t", "aː", "j", "e", "t"],
    "считаю": ["ɕː", "i", "t", "aː", "j", "u"],
    "мужчина": ["m", "u", "ɕː", "iː", "n", "a"],
    "мужчины": ["m", "u", "ɕː", "iː", "n", "ɨ"],
    # silent clusters стн/здн (лестница, поздно)
    "лестница": ["lʲ", "eː", "s", "nʲ", "i", "t͡s", "a"],
    "лестницы": ["lʲ", "eː", "s", "nʲ", "i", "t͡s", "ɨ"],
    "лестнице": ["lʲ", "eː", "s", "nʲ", "i", "t͡s", "e"],
    "поздно": ["p", "oː", "z", "n", "o"],
    "известно": ["i", "z", "vʲ", "eː", "s", "n", "o"],
    "грустно": ["ɡ", "r", "uː", "s", "n", "o"],
    "честно": ["t͡ɕ", "eː", "s", "n", "o"],
}


# ё-restoration: modern text overwhelmingly writes е for ё (самолет,
# еще, идет), which would otherwise mis-stress AND mis-vowel the word —
# restored forms hit the inherent-stress ё layer and segment as [o].
# Built from every ё-containing stress-lexicon token plus the word/stem
# lists below; е-spellings that are themselves real words (все, небо,
# берег) are never restored.
_YO_AMBIGUOUS = frozenset("""
все всем всех всеми небо берег слез мел осел поем узнаем заем
передохнем
""".split())

_YO_WORDS = """
ещё самолёт самолёта самолёту самолёте самолёты самолётов
счёт счёта счёту счёте отчёт отчёта отчёте расчёт расчёта
партнёр партнёра партнёру партнёры партнёров актёр актёра актёры
шофёр шофёра подъём подъёма приём приёма приёме объём объёма
ребёнок ребёнка ребёнку ребёнке котёнок щенок берёза берёзы берёзе
тётя тётю тёти мёд мёда лётчик лётчика ковёр костёр орёл осёл
пёс сёстрам звёзды звёздам гнёзда колёса колёсам
слёзы слёз серьёзно трёх четырёх её неё поёт поёте поёшь
идёт идёшь идём идёте несём везём найдём найдёт найдёшь придём придёт придёшь
уйдём уйдёт зайдёт перейдёт подойдёт произойдёт
""".split()

_YO_ADJ_STEMS = ("чёрн", "жёлт", "зелён", "весёл", "тяжёл", "серьёзн",
                 "далёк", "лёгк")
_ADJ_ENDINGS = (
    "ый", "ий", "ого", "его", "ому", "ему", "ым", "им", "ом", "ем",
    "ая", "яя", "ой", "ей", "ую", "юю", "ое", "ее", "ые", "ие",
    "ых", "их", "ыми", "ими", "о", "е",
)


def _build_yo_restore() -> typing.Dict[str, str]:
    from larynx_tpu_torch.text.g2p import ru_stress

    known = set(ru_stress.EXACT)
    out: typing.Dict[str, str] = {}

    def add(token: str) -> None:
        if "ё" not in token:
            return
        e_spelled = token.replace("ё", "е")
        if e_spelled not in known and e_spelled not in _YO_AMBIGUOUS:
            out[e_spelled] = token

    for token in known:
        add(token)
    for token in ru_stress.YO_FORMS:
        add(token)
    for token in _YO_WORDS:
        add(token)
    for stem in _YO_ADJ_STEMS:
        for end in _ADJ_ENDINGS:
            add(stem + end)
    return out


_YO_RESTORE = _build_yo_restore()


def _restore_yo(w: str) -> str:
    hit = _YO_RESTORE.get(w)
    if hit is not None:
        return hit
    # motion-verb pasts in -шёл (пришел, нашел, ушел ...); вы- prefix
    # verbs genuinely have е (вы́шел)
    if w.endswith("шел") and not w.startswith("вы") and len(w) >= 3:
        return w[:-3] + "шёл"
    return w


# Homographs whose stress needs sentence context.  "стоит" defaults to
# the position verb (стои́т "stands", matching the golden fixtures'
# сиди́т/стои́т/лежи́т row); a price context selects сто́ит "costs".
_PRICE_CONTEXT_PREV = {"сколько", "это", "что", "ничего", "немало", "дорого"}
_PRICE_CONTEXT_NEXT = {
    # normalized numbers / money words that follow "стоит X рублей"
    "один", "одну", "два", "две", "три", "четыре", "пять", "шесть",
    "семь", "восемь", "девять", "десять", "двадцать", "тридцать",
    "сорок", "пятьдесят", "сто", "двести", "триста", "тысячу", "тысячи",
    "миллион", "рубль", "рубля", "рублей", "копеек", "доллар",
    "доллара", "долларов", "евро", "дорого", "дёшево", "недорого",
    "денег", "столько",
}



# Russian letter names (spell-out / ALL-CAPS initialisms like США, МГУ)
_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "а": ["aː"], "б": ["b", "eː"], "в": ["vʲ", "eː"], "г": ["ɡ", "eː"],
    "д": ["dʲ", "eː"], "е": ["j", "eː"], "ё": ["j", "oː"],
    "ж": ["ʐ", "eː"], "з": ["zʲ", "eː"], "и": ["iː"],
    "й": ["iː", "k", "r", "aː", "t", "k", "o", "j", "e"],
    "к": ["k", "aː"], "л": ["eː", "lʲ"], "м": ["eː", "m"],
    "н": ["eː", "n"], "о": ["oː"], "п": ["p", "eː"], "р": ["eː", "r"],
    "с": ["eː", "s"], "т": ["t", "eː"], "у": ["uː"], "ф": ["eː", "f"],
    "х": ["x", "aː"], "ц": ["t͡s", "eː"], "ч": ["t͡ɕ", "eː"],
    "ш": ["ʂ", "aː"], "щ": ["ɕː", "aː"], "э": ["eː"], "ю": ["j", "uː"],
    "я": ["j", "aː"],
}


# Latin letters in Russian text (emails, domains, brand names) read
# via the Russian renderings of the English letter names (эй, би, си…)
# when ALL-CAPS, else transliterated and read as a Cyrillic word.
_LATIN_LETTER_NAMES: typing.Dict[str, typing.List[str]] = {
    "a": ["eː", "j"], "b": ["bʲ", "iː"], "c": ["sʲ", "iː"],
    "d": ["dʲ", "iː"], "e": ["iː"], "f": ["eː", "f"],
    "g": ["d", "ʐ", "ɨː"], "h": ["e", "j", "t͡ɕ"], "i": ["aː", "j"],
    "j": ["d", "ʐ", "e", "j"], "k": ["k", "eː", "j"],
    "l": ["eː", "l"], "m": ["eː", "m"], "n": ["eː", "n"],
    "o": ["oː", "u"], "p": ["pʲ", "iː"], "q": ["kʲ", "uː"],
    "r": ["aː", "r"], "s": ["eː", "s"], "t": ["tʲ", "iː"],
    "u": ["j", "uː"], "v": ["vʲ", "iː"],
    "w": ["d", "aː", "b", "l", "j", "u"], "x": ["eː", "k", "s"],
    "y": ["u", "aː", "j"], "z": ["zʲ", "e", "t"],
}

_LATIN_DIGRAPHS = (
    ("ch", "ч"), ("sh", "ш"), ("ph", "ф"), ("th", "т"), ("ck", "к"),
    ("oo", "у"), ("ee", "и"), ("ay", "ей"), ("ey", "ей"), ("qu", "кв"),
)
_LATIN_TO_CYR = {
    "a": "а", "b": "б", "c": "к", "d": "д", "e": "е", "f": "ф",
    "g": "г", "h": "х", "i": "и", "j": "й", "k": "к", "l": "л",
    "m": "м", "n": "н", "o": "о", "p": "п", "q": "к", "r": "р",
    "s": "с", "t": "т", "u": "у", "v": "в", "w": "в", "x": "кс",
    "y": "и", "z": "з",
}


def _transliterate_latin(w: str) -> str:
    # English silent final e (google -> гугл, nice -> нис)
    if (
        len(w) > 3
        and w.endswith("e")
        and w[-2] not in "aeiou"
        and any(ch in "aeiouy" for ch in w[:-1])
    ):
        w = w[:-1]
    out: typing.List[str] = []
    i = 0
    while i < len(w):
        for di, cyr in _LATIN_DIGRAPHS:
            if w.startswith(di, i):
                out.append(cyr)
                i += 2
                break
        else:
            ch = w[i]
            if ch == "c" and i + 1 < len(w) and w[i + 1] in "eiy":
                out.append("с")  # nice, cent — soft c
            else:
                out.append(_LATIN_TO_CYR.get(ch, ch))
            i += 1
    return "".join(out)


def phonemize(
    word: str, prev: str = "", nxt: str = "",
    context: typing.Optional[typing.Sequence[str]] = None,
    index: int = -1,
) -> typing.List[str]:
    w = word.lower().strip()
    if not w:
        return []
    if (
        word.isupper()
        and word.isalpha()
        and 2 <= len(word) <= 5
        and all(ch in _LETTER_NAMES for ch in w)
    ):
        return spell_letters(w, _LETTER_NAMES)
    if any("a" <= ch <= "z" for ch in w):
        if word.isupper() and word.isalpha() and len(word) <= 5:
            return spell_letters(w, _LATIN_LETTER_NAMES)
        w = _transliterate_latin(w)
    hit = _SEGMENT_EXCEPTIONS.get(w)
    if hit is not None:
        return list(hit)
    w = _restore_yo(w)
    out = _segments(w)

    vowel_idx = [k for k, p in enumerate(out) if p in _VOWEL_SYMBOLS]
    if not vowel_idx:
        return out
    if w == "стоит" and (
        prev.lower() in _PRICE_CONTEXT_PREV
        or nxt.lower() in _PRICE_CONTEXT_NEXT
    ):
        stressed: typing.Optional[int] = 0  # сто́ит "costs"
    else:
        stressed = stress_index(w, len(vowel_idx))
    if stressed is not None and 0 <= stressed < len(vowel_idx):
        k = vowel_idx[stressed]
        out[k] = out[k] + "ː"
    return out


phonemize.context_aware = True  # type: ignore[attr-defined]
