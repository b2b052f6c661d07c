# Copied from larynx_tpu/text/tokenize.py; only the package name in its imports differs.
"""Sentence segmentation and word tokenization.

Replaces gruut's tokenizer for the subset of behavior the pipeline needs:
split raw text into sentences, split sentences into word tokens, classify
punctuation into minor/major breaks, and expand number-like tokens through
:mod:`larynx_tpu.text.normalize`.
"""

import functools
import re
import typing

from larynx_tpu_torch.text.normalize import (
    DE_UNIT_NOUNS,
    DE_UNIT_NOUNS_F,
    MONTH_NAMES,
    SCORE_WORD,
    SYMBOL_WORDS,
    UNIT_ABBREVIATIONS,
    date_words,
    de_ordinal_to_words,
    degree_tokens,
    en_ordinal_to_words,
    fr_ordinal_to_words,
    fraction_words,
    kmh_tokens,
    measure_tokens,
    normalize_token,
    roman_to_int,
    roman_words,
    ru_day_genitive,
    ru_year_ordinal,
    slash_date_words,
    sv_number_to_words,
    sv_ordinal_to_words,
    sv_year_to_words,
    time_words,
    verbalize_urls,
)

# month-name lookups for the date pre-passes in words_of
_RU_MONTHS_GEN = frozenset(MONTH_NAMES["ru-ru"])
_SV_MONTHS = frozenset(MONTH_NAMES["sv-se"])
_EN_MONTHS = frozenset(MONTH_NAMES["en-us"])
_IT_MONTHS = frozenset(MONTH_NAMES["it-it"])
_FR_MONTHS = frozenset(MONTH_NAMES["fr-fr"])

# Sentence boundary: terminal punctuation followed by whitespace or EOT.
_SENT_BOUNDARY = re.compile(r"(?<=[.!?…])[\)\]\"'”’]*\s+")

# Common abbreviations that do not end a sentence (en-centric, harmless
# elsewhere)
_ABBREVIATIONS = {
    "mr.", "mrs.", "ms.", "dr.", "prof.", "sr.", "jr.", "st.", "etc.",
    "e.g.", "i.e.", "vs.", "inc.", "ltd.", "co.", "no.", "dept.", "est.",
    "approx.", "jan.", "feb.", "mar.", "apr.", "jun.", "jul.", "aug.",
    "sep.", "sept.", "oct.", "nov.", "dec.", "z.b.", "u.a.", "bzw.",
    "ca.", "usw.", "d.h.",
}

# German sentence-starter words (pronouns/adverbs/conjunctions, NOT nouns
# or articles): after a small-number+period, one of these capitalized means
# the number ended its sentence ("Er wurde 5. Danach kam ..."), anything
# else is an ordinal/date ("der 3. Mann", "am 5. Januar" — German nouns are
# capitalized, so a bare is-uppercase test cannot distinguish the cases).
_DE_STARTERS = {
    "Er", "Sie", "Es", "Ich", "Wir", "Ihr", "Man", "Aber", "Doch",
    "Jedoch", "Dann", "Danach", "Später", "Anschließend", "Schließlich",
    "Außerdem", "Deshalb", "Daher", "Darum", "Nun", "Jetzt", "Heute",
    "Morgen", "Gestern", "Zuerst", "Zudem", "Trotzdem", "Dennoch",
}

MINOR_PUNCT = {",", ";", ":", "-", "—", "–", "(", ")", "[", "]", "…"}
# NB: Spanish inverted marks (¡ ¿) open a sentence — they are dropped, not
# breaks (the golden fixtures have no leading ‖ for "¿Puedes ...?")
MAJOR_PUNCT = {".", "!", "?", "。"}

# Language-typical written ordinal tokens that the generic pattern would
# split apart ("1er" -> 1|er, "3:e" -> 3|:|e, "2-й" -> 2|-|й, "3." -> 3|.).
# Each entry is an extra alternative tried BEFORE the generic number branch
# so normalize_token sees the whole form (matching _ORDINAL_FORMS there).
_ORDINAL_TOKEN = {
    # decades ("the 1980s", "the 90s") stay one token; 2000s-style
    # hundreds-decades are left split (no idiomatic reading)
    "en-us": r"\d{0,2}[2-9]0s\b",
    "fr-fr": r"\d+(?:er|ère|ere|ème|eme|e)\b",
    "nl": r"\d+(?:ste|de|e)\b",
    "sv-se": r"\d+:[ea]\b",
    "ru-ru": r"\d+-(?:го|му|ых|ом|ой|й|я|е|х|м)\b",
    "es-es": r"\d+[ºª°]",
    "it-it": r"\d+[ºª°]",
    # German ordinals/dates are digit+period mid-sentence ("der 3. Mann",
    # "am 21. Dezember", "am 3., im Mai"); 1-2 digits only, so years keep
    # ending sentences; NOT at end-of-text, where the period is sentence-
    # final punctuation
    "de-de": r"\d+ern?\b|\d{1,2}\.(?=\s|[,;:)])",
}


@functools.lru_cache(maxsize=None)
def _token_re(lang: str) -> "re.Pattern[str]":
    """Token = word-ish run (letters/digits/' - embedded), number/money/
    time (with language-typical ordinal forms), or single punctuation."""
    ordinal = _ORDINAL_TOKEN.get(lang)
    return re.compile(
        r"\d+_[a-z]+"  # interpretation markers: 22_ordinal, 1963_year
        r"|\d+[x×]\d+"  # dimensions: 4x4, 1920x1080
        + (rf"|{ordinal}" if ordinal else "")
        + r"|[$€£]?\d+(?::\d{2}(?!\d))?(?:[.,]\d+)*[$€£%]?(?:st|nd|rd|th)?"  # numbers
        r"|[\w']+(?:[-'’][\w']+)*"  # words incl. apostrophes/hyphens
        r"|[^\w\s]",  # any single punctuation char
        re.UNICODE,
    )


def split_sentences(text: str, lang: str = "en-us") -> typing.List[str]:
    """Split text into sentences, keeping trailing punctuation."""
    text = text.strip()
    if not text:
        return []
    # Newlines always separate sentences (paragraph behavior)
    parts: typing.List[str] = []
    for chunk in re.split(r"\n+", text):
        chunk = chunk.strip()
        if not chunk:
            continue
        start = 0
        for m in _SENT_BOUNDARY.finditer(chunk):
            candidate = chunk[start : m.start() + 1].strip()
            # Don't split after abbreviations / single initials
            last_word = candidate.rsplit(" ", 1)[-1].lower()
            # single initials ("J."); digits are NOT initials — small
            # numbers get language-aware handling below
            if last_word in _ABBREVIATIONS or re.match(
                r"^[^\W\d_]\.$", last_word
            ):
                # French clock "8 h." is a time, not an initial — the
                # period does end the sentence
                if not (
                    lang == "fr-fr"
                    and last_word == "h."
                    and re.search(r"\d\s+h\.$", candidate)
                ):
                    continue
            # German ordinal/date periods ("der 3. Mann", "am 5. Januar")
            # are not sentence ends; years and longer numbers still are.
            # A sentence genuinely ending in a small number ("Er wurde 5.
            # Danach kam ...") is recognized by its continuation being a
            # capitalized sentence-starter word — ordinals are instead
            # followed by the (also capitalized) noun they modify.
            if lang == "de-de" and re.match(r"^\d{1,2}\.$", last_word):
                follow = chunk[m.end() :].lstrip()
                if (
                    not follow
                    or follow.split(" ", 1)[0].rstrip(".,!?")
                    not in _DE_STARTERS
                ):
                    continue
            # German regnal ordinals ("Wilhelm II. war Kaiser"): a
            # roman numeral + period followed by a lowercase word is
            # mid-sentence (sentence starts are always capitalized)
            raw_last = candidate.rsplit(" ", 1)[-1]
            if lang == "de-de" and re.match(r"^[IVX]{1,6}\.$", raw_last):
                follow = chunk[m.end() :].lstrip()
                if follow and follow[:1].islower():
                    continue
            if candidate:
                parts.append(chunk[start : m.end()].rstrip())
            start = m.end()
        tail = chunk[start:].strip()
        if tail:
            parts.append(tail)
    return parts


def tokenize(sentence: str, lang: str = "en-us") -> typing.List[str]:
    """Split one sentence into word/punctuation tokens."""
    return _token_re(lang).findall(sentence)


def classify_token(token: str) -> str:
    """'word', 'minor' (short pause), 'major' (sentence break), 'skip'."""
    if token in MINOR_PUNCT:
        return "minor"
    if token in MAJOR_PUNCT:
        return "major"
    if not any(ch.isalnum() for ch in token):
        return "skip"  # quotes and other non-break punctuation
    return "word"


# Spoken expansions for dotted abbreviations (the period is swallowed so
# "Dr. Smith" no longer breaks mid-sentence).  "no"/"st" are ambiguous
# with real words and get context conditions in words_of.
_ABBREV_EXPANSIONS: typing.Dict[str, typing.Dict[str, str]] = {
    "en-us": {
        "mr": "mister", "mrs": "missus", "ms": "miss", "dr": "doctor",
        "prof": "professor", "sr": "senior", "jr": "junior",
        "etc": "et cetera", "vs": "versus", "dept": "department",
        "approx": "approximately", "inc": "incorporated",
        "ltd": "limited",
        "jan": "January", "feb": "February", "mar": "March",
        "apr": "April", "jun": "June", "jul": "July", "aug": "August",
        "sep": "September", "sept": "September", "oct": "October",
        "nov": "November", "dec": "December",
    },
    "de-de": {
        "dr": "Doktor", "prof": "Professor", "nr": "Nummer",
        "ca": "zirka", "usw": "und so weiter",
        "bzw": "beziehungsweise", "abs": "Absatz",
        "ggf": "gegebenenfalls", "evtl": "eventuell",
        "inkl": "inklusive", "zzgl": "zuzüglich",
    },
    "fr-fr": {
        "mme": "madame", "mlle": "mademoiselle", "dr": "docteur",
        "etc": "et cétéra",
    },
    "es-es": {
        "sr": "señor", "sra": "señora", "srta": "señorita",
        "dr": "doctor", "dra": "doctora", "ud": "usted",
        "uds": "ustedes", "cap": "capítulo", "pág": "página",
        "núm": "número", "etc": "etcétera",
    },
    "it-it": {
        "sig": "signor", "dott": "dottor", "prof": "professor",
        "ecc": "eccetera", "cap": "capitolo", "pag": "pagina",
    },
    "nl": {
        "dhr": "de heer", "mevr": "mevrouw", "dr": "dokter",
        "prof": "professor", "nr": "nummer", "bijv": "bijvoorbeeld",
        "enz": "enzovoort", "blz": "bladzijde",
    },
    "sv-se": {
        "dr": "doktor", "nr": "nummer", "kr": "kronor",
        "kl": "klockan", "osv": "och så vidare",
        "dvs": "det vill säga",
    },
    "ru-ru": {
        "см": "смотри", "стр": "страница",
    },
}

# Multi-part dotted abbreviations ("z.B.", "t.ex.", "и т.д."): each part
# lexes as its own token followed by a "." token.
_MULTI_ABBREVS: typing.Dict[str, typing.Dict[typing.Tuple[str, ...], str]] = {
    "en-us": {("e", "g"): "for example", ("i", "e"): "that is"},
    "de-de": {
        ("z", "b"): "zum Beispiel",
        ("d", "h"): "das heißt",
        ("u", "a"): "unter anderem",
    },
    "sv-se": {
        ("t", "ex"): "till exempel",
        ("bl", "a"): "bland annat",
        ("m", "m"): "med mera",
        ("d", "v", "s"): "det vill säga",
        ("o", "s", "v"): "och så vidare",
    },
    "ru-ru": {
        ("т", "д"): "так далее",
        ("т", "е"): "то есть",
        ("т", "п"): "тому подобное",
    },
    "fr-fr": {("p", "ex"): "par exemple"},
    "es-es": {("p", "ej"): "por ejemplo"},
    "nl": {
        ("d", "w", "z"): "dat wil zeggen",
        ("o", "a"): "onder andere",
        ("m", "a", "w"): "met andere woorden",
    },
}

# every expandable abbreviation also protects the sentence splitter
_ABBREVIATIONS |= {
    key + "."
    for lang_map in _ABBREV_EXPANSIONS.values()
    for key in lang_map
}
_ABBREVIATIONS |= {
    ".".join(parts) + "."
    for lang_map in _MULTI_ABBREVS.values()
    for parts in lang_map
}


def words_of(
    sentence: str, lang: str = "en-us"
) -> typing.List[typing.Tuple[str, str]]:
    """Tokenize + normalize: [(kind, token), ...] with numbers expanded.

    ``kind`` is 'word'/'minor'/'major'.
    """
    out: typing.List[typing.Tuple[str, str]] = []
    # email addresses / bare domains verbalize at the string level —
    # their periods must not tokenize into sentence-break punctuation
    if "@" in sentence or "." in sentence:
        sentence = verbalize_urls(sentence, lang)
    tokens = tokenize(sentence, lang)
    # space-grouped thousands ("1 234 567,89" — the French/Swedish/
    # Russian convention) re-join into one number token for normalize
    if any(re.fullmatch(r"\d{1,3}", t) for t in tokens):
        joined: typing.List[str] = []
        k = 0
        while k < len(tokens):
            t = tokens[k]
            if re.fullmatch(r"\d{1,3}", t):
                j = k + 1
                while j < len(tokens) and re.fullmatch(r"\d{3}", tokens[j]):
                    j += 1
                # the final group may carry the decimal part
                if j < len(tokens) and re.fullmatch(
                    r"\d{3}[.,]\d+", tokens[j]
                ):
                    j += 1
                if j > k + 1:
                    joined.append("".join(tokens[k:j]))
                    k = j
                    continue
            joined.append(t)
            k += 1
        tokens = joined
    # a minus sign binds to a following number when it cannot be a range
    # ("-5 degrees" -> minus five); between two numbers it stays a pause
    # ("3-2" -> three, pause, two)
    if "-" in tokens or "−" in tokens:
        signed: typing.List[str] = []
        k = 0
        while k < len(tokens):
            t = tokens[k]
            if (
                t in ("-", "−")
                and k + 1 < len(tokens)
                and tokens[k + 1][:1].isdigit()
                and (k == 0 or not tokens[k - 1][-1:].isdigit())
            ):
                signed.append("-" + tokens[k + 1])
                k += 2
                continue
            signed.append(t)
            k += 1
        tokens = signed
    # model/product names "A380", "MP3", "B52": split the letter prefix
    # from the digits so both are spoken (G2P would otherwise drop the
    # digits). Ordinal forms (2nd, 90er, 1er) lex as single tokens
    # earlier and never reach this shape.
    for k, t in enumerate(tokens):
        mm = re.fullmatch(r"([A-ZÄÖÜ]{1,4})(\d{1,4})", t)
        if mm:
            letters = mm.group(1)
            if lang == "en-us" and letters == "A":
                letters = "ay"  # letter name; bare "A" reads as the article
            tokens[k] = f"{letters} {mm.group(2)}"
    if any(" " in t for t in tokens):
        tokens = [w for t in tokens for w in t.split(" ") if w]
    # scores/ratios: "3:2", "1:1000" (clock times lex as single tokens,
    # so a bare colon between numbers is never a time) — the colon reads
    # as the language's score word where one exists (drei zu zwei)
    score = SCORE_WORD.get(lang)
    if score and ":" in tokens:
        for k, t in enumerate(tokens):
            if (
                t == ":"
                and 0 < k < len(tokens) - 1
                and tokens[k - 1][-1:].isdigit()
                and tokens[k + 1][:1].isdigit()
            ):
                # h:mm:ss durations ("1:23:45" lexes as time + ":" + ss):
                # read the groups in sequence, not as a score
                if re.fullmatch(
                    r"\d{1,2}:\d{2}", tokens[k - 1]
                ) and re.fullmatch(r"[0-5]\d", tokens[k + 1]):
                    tokens[k] = ""
                    continue
                tokens[k] = score
        tokens = [t for t in tokens if t]
    # Russian money with the currency NOUN (25,50 рублей): the decimal
    # reads as whole + noun + kopecks, never digit-wise запятая
    if lang == "ru-ru":
        rubled: typing.List[str] = []
        k = 0
        while k < len(tokens):
            t = tokens[k]
            nxt_tok = tokens[k + 1] if k + 1 < len(tokens) else ""
            dm = re.fullmatch(r"(\d+),(\d{1,2})", t)
            if dm and nxt_tok.lower() in (
                "рубль", "рубля", "рублей", "руб",
                "доллар", "доллара", "долларов", "евро",
            ):
                from larynx_tpu_torch.text.normalize import ru_number_to_words
                kop = int(dm.group(2))
                last, teens = kop % 10, 11 <= kop % 100 <= 14
                dollar = nxt_tok.lower().startswith("доллар")
                sub = (
                    ("цент", "цента", "центов") if dollar
                    else ("копейка", "копейки", "копеек")
                )
                kop_word = (
                    sub[0] if last == 1 and not teens
                    else sub[1] if 2 <= last <= 4 and not teens
                    else sub[2]
                )
                kop_words = ru_number_to_words(kop)
                if not dollar:  # копейка is feminine: одна, две
                    kop_words = re.sub(r"один$", "одна", kop_words)
                    kop_words = re.sub(r"два$", "две", kop_words)
                rubled.append(ru_number_to_words(int(dm.group(1))))
                rubled.append(nxt_tok)
                rubled.append(kop_words)
                rubled.append(kop_word)
                k += 2
                continue
            rubled.append(t)
            k += 1
        tokens = rubled
    # standalone currency symbols attach to the neighboring number
    # ("5 €" / "€ 5" -> one 5€ token for normalize)
    if any(t in ("$", "€", "£", "%") for t in tokens):
        merged: typing.List[str] = []
        k = 0
        while k < len(tokens):
            t = tokens[k]
            nxt_tok = tokens[k + 1] if k + 1 < len(tokens) else ""
            if t in ("$", "€", "£") and nxt_tok[:1].isdigit():
                merged.append(t + nxt_tok)
                k += 2
            elif t[:1].isdigit() and nxt_tok in ("$", "€", "£", "%"):
                merged.append(t + nxt_tok)
                k += 2
            else:
                merged.append(t)
                k += 1
        tokens = merged
    multi = _MULTI_ABBREVS.get(lang)
    if multi and "." in tokens:
        multi_out: typing.List[str] = []
        k = 0
        while k < len(tokens):
            matched = None
            for parts, spoken in multi.items():
                need = len(parts) * 2  # tok "." tok "." ...
                seq = tokens[k : k + need]
                if len(seq) == need and all(
                    seq[2 * j].lower() == parts[j] and seq[2 * j + 1] == "."
                    for j in range(len(parts))
                ):
                    matched = (spoken, need)
                    break
            if matched:
                spoken, need = matched
                multi_out.extend(spoken.split())
                # swallow inner periods; keep a sentence-final one
                if k + need >= len(tokens):
                    multi_out.append(".")
                k += need
            else:
                multi_out.append(tokens[k])
                k += 1
        tokens = multi_out
    abbrevs = _ABBREV_EXPANSIONS.get(lang)
    if abbrevs:
        expanded_tokens: typing.List[str] = []
        k = 0
        while k < len(tokens):
            t = tokens[k]
            low = t.lower()
            nxt_is_dot = k + 1 < len(tokens) and tokens[k + 1] == "."
            after = tokens[k + 2] if k + 2 < len(tokens) else ""
            spoken = None
            if nxt_is_dot:
                spoken = abbrevs.get(low)
                if lang == "en-us" and low == "no" and after[:1].isdigit():
                    spoken = "number"  # "No. 5"
                elif lang == "en-us" and low == "st":
                    # "St. Peter" saint, "Main St." street
                    spoken = "saint" if after[:1].isupper() else "street"
                elif (
                    lang == "fr-fr"
                    and t == "M"
                    and after[:1].isupper()
                ):
                    spoken = "monsieur"  # "M. Dupont"
            if spoken is not None:
                expanded_tokens.extend(spoken.split())
                # swallow the period mid-sentence; keep a sentence-final one
                if k + 2 >= len(tokens):
                    expanded_tokens.append(".")
                k += 2
            else:
                expanded_tokens.append(t)
                k += 1
        tokens = expanded_tokens
    # "7:30 Uhr" / "saa 4:30": the clock word is already part of the
    # spoken time expansion ("sieben Uhr dreißig", "saa nne ...") —
    # drop the written one next to an h:mm token (after it in de/nl,
    # before it in sw)
    clock_word = {"de-de": "uhr", "nl": "uur", "sw": "saa"}.get(lang)
    if clock_word:
        def _is_time(k):
            return 0 <= k < len(tokens) and re.match(
                r"^\d{1,2}:\d{2}$", tokens[k]
            )

        tokens = [
            t
            for k, t in enumerate(tokens)
            if not (
                t.lower() == clock_word
                and (_is_time(k - 1) or _is_time(k + 1))
            )
        ]
    # measurements and fractions: "25°C" -> 25 Grad Celsius, "5 km" ->
    # 5 + kilometer-word, "120 km/h" -> 120 Kilometer pro Stunde,
    # "3/4" -> drei Viertel. The unit becomes plain word tokens; the
    # number token itself is expanded by normalize_token below.
    if any(
        "°" in t
        or t == "/"
        or t.lower() in UNIT_ABBREVIATIONS
        or (lang == "fr-fr" and (t == "h" or re.fullmatch(r"h[0-5]\d", t)))
        for t in tokens
    ):
        measured: typing.List[str] = []
        k = 0
        while k < len(tokens):
            t = tokens[k]
            nxt = tokens[k + 1] if k + 1 < len(tokens) else ""
            n2 = tokens[k + 2] if k + 2 < len(tokens) else ""
            n3 = tokens[k + 3] if k + 3 < len(tokens) else ""
            is_num = bool(re.fullmatch(r"-?\d+(?:[.,]\d+)?", t))
            rep = None
            if is_num and nxt == "°":
                scale = n2 if n2 in ("C", "F") else None
                rep = degree_tokens(t, scale, lang)
                step = 3 if scale else 2
            elif (
                # "N° 5" (numéro) in the Romance languages
                t in ("N", "n")
                and nxt in ("°", "º")
                and n2[:1].isdigit()
                and lang in ("fr-fr", "it-it", "es-es")
            ):
                rep = [
                    {"fr-fr": "numéro", "it-it": "numero",
                     "es-es": "número"}[lang],
                ]
                step = 2
            elif (
                # es/it tokenize "25°" as one ordinal-marked token; a
                # following C/F disambiguates it as a temperature
                re.fullmatch(r"-?\d+(?:[.,]\d+)?°", t)
                and nxt in ("C", "F")
            ):
                rep = degree_tokens(t[:-1], nxt, lang)
                step = 2
            elif (
                is_num
                and nxt.lower() in ("km", "км")
                and n2 == "/"
                and n3.lower() in ("h", "ч")
            ):
                rep = kmh_tokens(t, lang)
                step = 4
            elif (
                # French compact clock "18h30" (lexes as "18" + "h30")
                lang == "fr-fr"
                and re.fullmatch(r"\d{1,2}", t)
                and re.fullmatch(r"h[0-5]\d", nxt)
                and 0 <= int(t) <= 23
            ):
                spoken = time_words(int(t), int(nxt[1:]), lang)
                if spoken:
                    rep = spoken.split()
                step = 2
            elif (
                # French written clock "21 h 30" / "8 h"
                lang == "fr-fr"
                and re.fullmatch(r"\d{1,2}", t)
                and nxt == "h"
                and 0 <= int(t) <= 23
            ):
                mins = (
                    int(n2)
                    if re.fullmatch(r"[0-5]?\d", n2 or "")
                    else None
                )
                spoken = time_words(int(t), mins or 0, lang)
                if spoken:
                    rep = spoken.split()
                    step = 3 if mins is not None else 2
            elif is_num and nxt:
                rep = measure_tokens(t, nxt, lang)
                step = 2
            elif (
                lang == "sw"
                and t.isalpha()
                and nxt
                and re.fullmatch(r"\d+(?:[.,]\d+)?", nxt)
            ):
                # Swahili writes the unit before the number ("km 5" ->
                # kilomita tano); keep that order in the spoken form
                m = measure_tokens(nxt, t, lang)
                if m is not None:
                    rep = m[1:] + [nxt]
                    step = 2
            if rep is None and (
                re.fullmatch(r"\d{1,2}", t)
                and nxt == "/"
                and re.fullmatch(r"\d{1,2}", n2)
                and n3 == "/"
                and (k == 0 or tokens[k - 1] != "/")
            ):
                # slashed numeric date: en-us m/d/y with the month name
                # ("3/4/2021" -> March fourth ...), d/m/y elsewhere
                n4 = tokens[k + 4] if k + 4 < len(tokens) else ""
                spoken = slash_date_words(t, n2, n4, lang)
                if spoken is not None:
                    rep = spoken.split()
                    step = 5
            if rep is None and (
                re.fullmatch(r"\d{1,2}", t)
                and nxt == "/"
                and re.fullmatch(r"\d{1,2}", n2)
                and n3 != "/"
                and (k == 0 or tokens[k - 1] != "/")
                and int(t) < int(n2)
            ):
                # simple written fraction, not part of a slashed date
                spoken = fraction_words(int(t), int(n2), lang)
                if spoken is not None:
                    rep = spoken.split()
                    step = 3
            if rep is not None:
                # "Ni nyuzi 25°C": the written degree word is already
                # part of the expansion — drop the doubled one
                if (
                    lang == "sw"
                    and measured
                    and rep[:1] == ["nyuzi"]
                    and measured[-1].lower() == "nyuzi"
                ):
                    measured.pop()
                measured.extend(rep)
                k += step
            else:
                measured.append(t)
                k += 1
        tokens = measured
    # spoken symbols: & reads as "and" between words; + and = read
    # only with alphanumeric neighbors on both sides ("2+2=4", "A+")
    if any(t in SYMBOL_WORDS for t in tokens):
        spoken_syms: typing.List[str] = []
        for k, t in enumerate(tokens):
            word_map = SYMBOL_WORDS.get(t)
            if word_map is not None:
                prev_ok = k > 0 and tokens[k - 1][-1:].isalnum()
                nxt_ok = (
                    k + 1 < len(tokens) and tokens[k + 1][:1].isalnum()
                )
                joins = prev_ok and (nxt_ok or t == "+")
                spoken = word_map.get(lang) if joins else None
                if spoken is not None:
                    spoken_syms.extend(spoken.split())
                    continue
            spoken_syms.append(t)
        tokens = spoken_syms
    # roman numerals in reading contexts ("Chapter IV", "Henry VIII",
    # "Wilhelm II."). The German written style puts an ordinal period
    # after the numeral; swallow it when the sentence continues in
    # lowercase so "Wilhelm II. war" doesn't pause mid-clause.
    def _romanish(t: str) -> bool:
        if t.isupper() and set(t) <= set("IVXLCDM"):
            return True
        return lang == "fr-fr" and t in ("Ier", "Ière", "1er")

    # French roman ordinals carry their own suffix ("le XXe siècle",
    # "IIIème millénaire") — unambiguous without any context word
    if lang == "fr-fr":
        for k, t in enumerate(tokens):
            rm = re.fullmatch(r"([IVXLCDM]+)(e|ème|eme)", t)
            # single-letter romans only for V/X ("Ve République",
            # "Xe siècle") — "Le"/"Ce"/"De"/"Me" are ordinary words
            if (
                rm
                and rm.group(1).isupper()
                and (len(rm.group(1)) >= 2 or rm.group(1) in ("V", "X"))
            ):
                value = roman_to_int(rm.group(1))
                if value is not None and 1 <= value <= 100:
                    tokens[k] = fr_ordinal_to_words(value)

    if any(_romanish(t) for t in tokens):
        romanized: typing.List[str] = []
        k = 0
        while k < len(tokens):
            t = tokens[k]
            if _romanish(t):
                spoken = roman_words(
                    tokens[k - 1] if k > 0 else "",
                    t,
                    lang,
                    tokens[k + 1] if k + 1 < len(tokens) else "",
                )
                if spoken is not None:
                    romanized.extend(spoken.split())
                    if (
                        k + 2 < len(tokens)
                        and tokens[k + 1] == "."
                        and tokens[k + 2][:1].islower()
                    ):
                        k += 2  # skip the ordinal period too
                    else:
                        k += 1
                    continue
            romanized.append(t)
            k += 1
        tokens = romanized
    # Dutch dashed dates tokenize as 12 - 05 - 2021: re-join the
    # d-m-y run so date_words can read it with the month name
    if lang == "nl" and "-" in tokens:
        rejoined: typing.List[str] = []
        k = 0
        while k < len(tokens):
            if (
                k + 4 < len(tokens)
                and re.fullmatch(r"\d{1,2}", tokens[k])
                and tokens[k + 1] == "-"
                and re.fullmatch(r"\d{1,2}", tokens[k + 2])
                and tokens[k + 3] == "-"
                and re.fullmatch(r"\d{4}", tokens[k + 4])
            ):
                rejoined.append("-".join(
                    (tokens[k], tokens[k + 2], tokens[k + 4])
                ))
                k += 5
                continue
            rejoined.append(tokens[k])
            k += 1
        tokens = rejoined
    # German date/ordinal case agreement: after am/vom/zum/dem/den the
    # ordinal is weak dative/accusative ("am 3. Mai" -> "am dritten",
    # "am 12.05.2021" -> "am zwölften Mai ..."); after der/die/das the
    # weak nominative drops the strong -r ("der zwölfte Mai")
    if lang == "de-de":
        for k, t in enumerate(tokens):
            prev = tokens[k - 1].lower() if k > 0 else ""
            dative = prev in ("am", "vom", "zum", "im", "dem", "den")
            m = re.fullmatch(r"(\d{1,2})\.", t)
            if m and dative:
                tokens[k] = de_ordinal_to_words(int(m.group(1))) + "n"
                continue
            if dative or prev in ("der", "die", "das"):
                spoken = date_words(
                    t, lang, case="dat" if dative else "nom_weak"
                )
                if spoken is not None:
                    tokens[k] = spoken
                    continue
            # the numeral 1 inflects before a unit noun: ein Kilometer,
            # eine Minute (standalone it stays "eins")
            if t == "1" and k + 1 < len(tokens):
                nxt_t = tokens[k + 1]
                if nxt_t in DE_UNIT_NOUNS_F:
                    tokens[k] = "eine"
                elif nxt_t in DE_UNIT_NOUNS:
                    tokens[k] = "ein"
    # Russian year ordinals: "в 1999 году" -> "... девяносто девятом
    # году"; "1999 года" -> "девятого года"; "1999 год" -> "девятый"
    if lang == "ru-ru":
        _RU_YEAR_CASE = {"год": "nom", "года": "gen", "году": "prep"}
        for k, t in enumerate(tokens):
            nxt = tokens[k + 1].lower() if k + 1 < len(tokens) else ""
            if re.fullmatch(r"[12]\d{3}", t) and nxt in _RU_YEAR_CASE:
                tokens[k] = ru_year_ordinal(int(t), _RU_YEAR_CASE[nxt])
            elif (
                re.fullmatch(r"\d{1,2}", t)
                and nxt in _RU_MONTHS_GEN
                and 1 <= int(t) <= 31
            ):
                # день before a month name: "12 мая" -> двенадцатого
                tokens[k] = ru_day_genitive(int(t))
    # Swedish dates: "(den) 12 maj" -> "den tolfte maj"; common-gender
    # "1 krona" takes "en" (the standalone numeral is neuter "ett")
    if lang == "sv-se":
        for k, t in enumerate(tokens):
            nxt = tokens[k + 1].lower() if k + 1 < len(tokens) else ""
            if (
                re.fullmatch(r"\d{1,2}", t)
                and nxt in _SV_MONTHS
                and 1 <= int(t) <= 31
            ):
                tokens[k] = sv_ordinal_to_words(int(t))
            elif t == "1" and nxt in ("krona", "kronan", "minut", "timme"):
                tokens[k] = "en"
            elif (
                # decade compounds: "1990-talet" nittonhundranittiotalet,
                # "90-talet" nittiotalet (one word; the dash is silent)
                re.fullmatch(r"\d{2}|\d{4}", t)
                and nxt == "-"
                and k + 2 < len(tokens)
                and re.fullmatch(r"tal(?:et|ets|s)?", tokens[k + 2])
            ):
                n = int(t)
                base = sv_year_to_words(n) if n >= 1000 else sv_number_to_words(n)
                tokens[k] = base + tokens[k + 2]
                tokens[k + 1] = ""
                tokens[k + 2] = ""
    # English month-day: "May 12" -> "May twelfth" (day-first "12 May"
    # stays cardinal); the month token must be capitalized
    if lang == "en-us":
        for k, t in enumerate(tokens):
            prev = tokens[k - 1] if k > 0 else ""
            if (
                re.fullmatch(r"\d{1,2}", t)
                and prev in _EN_MONTHS
                and 1 <= int(t) <= 31
            ):
                tokens[k] = en_ordinal_to_words(int(t))
        # North-American phone groups (555-0123, 555-123-4567) read
        # digit by digit, never as hundreds; dashes stay as pauses
        k = 0
        while k < len(tokens):
            # match a run NNN-NNNN or NNN-NNN-NNNN starting at k
            if re.fullmatch(r"\d{3}", tokens[k]):
                if (
                    k + 4 < len(tokens)
                    and tokens[k + 1] == tokens[k + 3] == "-"
                    and re.fullmatch(r"\d{3}", tokens[k + 2])
                    and re.fullmatch(r"\d{4}", tokens[k + 4])
                ):
                    for j in (k, k + 2, k + 4):
                        tokens[j] = " ".join(tokens[j])
                    k += 5
                    continue
                if (
                    k + 2 < len(tokens)
                    and tokens[k + 1] == "-"
                    and re.fullmatch(r"\d{4}", tokens[k + 2])
                    and not (k + 3 < len(tokens) and tokens[k + 3] == "-")
                ):
                    tokens[k] = " ".join(tokens[k])
                    tokens[k + 2] = " ".join(tokens[k + 2])
                    k += 3
                    continue
            k += 1
    # Italian/French first of the month is ordinal: "il 1 maggio" ->
    # "il primo maggio", "le 1 mai" -> "le premier mai" (other days
    # stay cardinal in both languages)
    if lang == "it-it":
        for k, t in enumerate(tokens):
            nxt = tokens[k + 1].lower() if k + 1 < len(tokens) else ""
            if t in ("1", "1º") and nxt in _IT_MONTHS:
                tokens[k] = "primo"
    if lang == "fr-fr":
        for k, t in enumerate(tokens):
            nxt = tokens[k + 1].lower() if k + 1 < len(tokens) else ""
            if t == "1" and nxt in _FR_MONTHS:
                tokens[k] = "premier"
    # the date/year pre-passes above splice multi-word phrases into
    # single slots (and may blank consumed tokens); raw tokens never
    # contain spaces, so split them out and drop the blanks
    if any(" " in t or not t for t in tokens):
        tokens = [w for t in tokens for w in t.split(" ") if w]
    for token in tokens:
        kind = classify_token(token)
        if kind == "skip":
            continue
        if kind != "word":
            out.append((kind, token))
            continue
        expanded = normalize_token(token, lang)
        if expanded is not None:
            for word in expanded.split():
                out.append(("word", word))
        else:
            out.append(("word", token))
    return out
