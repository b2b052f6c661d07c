# Copied from larynx_tpu/text/normalize.py; only the package name in its imports and the reference path in a comment differ.
"""Text normalization: expand numbers, ordinals, years, and currency into
words, per language.

Replaces the verbalization gruut performed before phonemization (the
reference delegates this entirely to the gruut dependency).  English covers
cardinals/ordinals/years/decimals/currency; other languages cover cardinals
and decimals.
"""

import re
import typing

# -----------------------------------------------------------------------------
# English


_EN_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_EN_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand")]

_EN_ORD_IRREG = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def en_number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + en_number_to_words(-n)
    if n < 20:
        return _EN_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        word = _EN_TENS[tens]
        return f"{word} {_EN_ONES[rest]}" if rest else word
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = f"{_EN_ONES[hundreds]} hundred"
        return f"{word} {en_number_to_words(rest)}" if rest else word
    for scale, name in _EN_SCALE:
        if n >= scale:
            major, rest = divmod(n, scale)
            word = f"{en_number_to_words(major)} {name}"
            return f"{word} {en_number_to_words(rest)}" if rest else word
    return str(n)


def en_ordinal_to_words(n: int) -> str:
    words = en_number_to_words(n).split()
    last = words[-1]
    if last in _EN_ORD_IRREG:
        words[-1] = _EN_ORD_IRREG[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    elif last in ("hundred", "thousand", "million", "billion"):
        words[-1] = last + "th"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def en_year_to_words(n: int) -> str:
    """1963 -> nineteen sixty three; 2011 -> two thousand eleven."""
    if 1001 <= n <= 1999 or (2100 <= n <= 9999 and (n % 100) != 0):
        high, low = divmod(n, 100)
        if low == 0:
            return f"{en_number_to_words(high)} hundred"
        if low < 10:
            return f"{en_number_to_words(high)} oh {_EN_ONES[low]}"
        return f"{en_number_to_words(high)} {en_number_to_words(low)}"
    return en_number_to_words(n)


# -----------------------------------------------------------------------------
# German

_DE_ONES = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
    "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
    "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
_DE_TENS = [
    "", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
    "siebzig", "achtzig", "neunzig",
]
_DE_UNIT = ["", "ein", "zwei", "drei", "vier", "fünf", "sechs", "sieben", "acht", "neun"]


def de_number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + de_number_to_words(-n)
    if n < 20:
        return _DE_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        if rest:
            return f"{_DE_UNIT[rest]}und{_DE_TENS[tens]}"
        return _DE_TENS[tens]
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = f"{_DE_UNIT[hundreds]}hundert"
        return word + (de_number_to_words(rest) if rest else "")
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        prefix = (
            "eintausend"
            if thousands == 1
            else de_number_to_words(thousands) + "tausend"
        )
        return prefix + (de_number_to_words(rest) if rest else "")
    millions, rest = divmod(n, 10**6)
    word = (
        "eine Million"
        if millions == 1
        else de_number_to_words(millions) + " Millionen"
    )
    return word + (" " + de_number_to_words(rest) if rest else "")


# -----------------------------------------------------------------------------
# Spanish

_ES_ONES = [
    "cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete",
    "ocho", "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
    "dieciséis", "diecisiete", "dieciocho", "diecinueve", "veinte",
    "veintiuno", "veintidós", "veintitrés", "veinticuatro", "veinticinco",
    "veintiséis", "veintisiete", "veintiocho", "veintinueve",
]
_ES_TENS = [
    "", "", "", "treinta", "cuarenta", "cincuenta", "sesenta", "setenta",
    "ochenta", "noventa",
]
_ES_HUNDREDS = [
    "", "ciento", "doscientos", "trescientos", "cuatrocientos",
    "quinientos", "seiscientos", "setecientos", "ochocientos",
    "novecientos",
]


def es_number_to_words(n: int) -> str:
    if n < 0:
        return "menos " + es_number_to_words(-n)
    if n < 30:
        return _ES_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        if rest:
            return f"{_ES_TENS[tens]} y {_ES_ONES[rest]}"
        return _ES_TENS[tens]
    if n == 100:
        return "cien"
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = _ES_HUNDREDS[hundreds]
        return f"{word} {es_number_to_words(rest)}" if rest else word
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        prefix = "mil" if thousands == 1 else es_number_to_words(thousands) + " mil"
        return f"{prefix} {es_number_to_words(rest)}" if rest else prefix
    millions, rest = divmod(n, 10**6)
    word = "un millón" if millions == 1 else es_number_to_words(millions) + " millones"
    return f"{word} {es_number_to_words(rest)}" if rest else word


# -----------------------------------------------------------------------------
# French

_FR_ONES = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
    "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
    "dix-sept", "dix-huit", "dix-neuf",
]
_FR_TENS = [
    "", "", "vingt", "trente", "quarante", "cinquante", "soixante",
]


def fr_number_to_words(n: int) -> str:
    if n < 0:
        return "moins " + fr_number_to_words(-n)
    if n < 20:
        return _FR_ONES[n]
    if n < 70:
        tens, rest = divmod(n, 10)
        word = _FR_TENS[tens]
        if rest == 1:
            return f"{word} et un"
        return f"{word}-{_FR_ONES[rest]}" if rest else word
    if n < 80:
        rest = n - 60
        if rest == 11:
            return "soixante et onze"
        return f"soixante-{_FR_ONES[rest]}"
    if n < 100:
        rest = n - 80
        if rest == 0:
            return "quatre-vingts"
        return f"quatre-vingt-{_FR_ONES[rest]}"
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = "cent" if hundreds == 1 else f"{_FR_ONES[hundreds]} cents"
        if rest:
            base = "cent" if hundreds == 1 else f"{_FR_ONES[hundreds]} cent"
            return f"{base} {fr_number_to_words(rest)}"
        return word
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        prefix = "mille" if thousands == 1 else fr_number_to_words(thousands) + " mille"
        return f"{prefix} {fr_number_to_words(rest)}" if rest else prefix
    millions, rest = divmod(n, 10**6)
    word = (
        "un million" if millions == 1 else fr_number_to_words(millions) + " millions"
    )
    return f"{word} {fr_number_to_words(rest)}" if rest else word


# -----------------------------------------------------------------------------
# Italian

_IT_ONES = [
    "zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette",
    "otto", "nove", "dieci", "undici", "dodici", "tredici", "quattordici",
    "quindici", "sedici", "diciassette", "diciotto", "diciannove",
]
_IT_TENS = [
    "", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
    "settanta", "ottanta", "novanta",
]


def it_number_to_words(n: int) -> str:
    if n < 0:
        return "meno " + it_number_to_words(-n)
    if n < 20:
        return _IT_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        word = _IT_TENS[tens]
        if rest in (1, 8):  # elision before vowel
            word = word[:-1]
        return word + (_IT_ONES[rest] if rest else "")
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = "cento" if hundreds == 1 else _IT_ONES[hundreds] + "cento"
        return word + (it_number_to_words(rest) if rest else "")
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        prefix = "mille" if thousands == 1 else it_number_to_words(thousands) + "mila"
        return prefix + (it_number_to_words(rest) if rest else "")
    millions, rest = divmod(n, 10**6)
    word = (
        "un milione" if millions == 1 else it_number_to_words(millions) + " milioni"
    )
    return f"{word} {it_number_to_words(rest)}" if rest else word


# -----------------------------------------------------------------------------
# Dutch

_NL_ONES = [
    "nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven", "acht",
    "negen", "tien", "elf", "twaalf", "dertien", "veertien", "vijftien",
    "zestien", "zeventien", "achttien", "negentien",
]
_NL_TENS = [
    "", "", "twintig", "dertig", "veertig", "vijftig", "zestig",
    "zeventig", "tachtig", "negentig",
]


def nl_number_to_words(n: int) -> str:
    if n < 0:
        return "min " + nl_number_to_words(-n)
    if n == 1:
        return "één"  # the numeral; bare "een" reads as the article [ən]
    if n < 20:
        return _NL_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        if rest:
            joiner = "ën" if _NL_ONES[rest].endswith("e") else "en"
            return f"{_NL_ONES[rest]}{joiner}{_NL_TENS[tens]}"
        return _NL_TENS[tens]
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = "honderd" if hundreds == 1 else _NL_ONES[hundreds] + "honderd"
        return word + (nl_number_to_words(rest) if rest else "")
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        prefix = "duizend" if thousands == 1 else nl_number_to_words(thousands) + "duizend"
        return prefix + (" " + nl_number_to_words(rest) if rest else "")
    millions, rest = divmod(n, 10**6)
    word = (
        "een miljoen" if millions == 1 else nl_number_to_words(millions) + " miljoen"
    )
    return f"{word} {nl_number_to_words(rest)}" if rest else word


# -----------------------------------------------------------------------------
# Russian

_RU_ONES = [
    "ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
    "восемь", "девять", "десять", "одиннадцать", "двенадцать",
    "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать",
    "семнадцать", "восемнадцать", "девятнадцать",
]
_RU_TENS = [
    "", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят",
    "семьдесят", "восемьдесят", "девяносто",
]
_RU_HUNDREDS = [
    "", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот",
    "семьсот", "восемьсот", "девятьсот",
]


def ru_number_to_words(n: int) -> str:
    if n < 0:
        return "минус " + ru_number_to_words(-n)
    if n < 20:
        return _RU_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        word = _RU_TENS[tens]
        return f"{word} {_RU_ONES[rest]}" if rest else word
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = _RU_HUNDREDS[hundreds]
        return f"{word} {ru_number_to_words(rest)}" if rest else word
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        last = thousands % 10
        last2 = thousands % 100
        if thousands == 1:
            prefix = "одна тысяча"
        elif last == 1 and last2 != 11:
            prefix = ru_number_to_words(thousands - 1) + " одна тысяча"
        elif 2 <= last <= 4 and not 12 <= last2 <= 14:
            head = ru_number_to_words(thousands)
            if last == 2:
                head = head.rsplit(" ", 1)[0] + " две" if " " in head else "две"
            prefix = head + " тысячи"
        else:
            prefix = ru_number_to_words(thousands) + " тысяч"
        return f"{prefix} {ru_number_to_words(rest)}" if rest else prefix
    millions, rest = divmod(n, 10**6)
    word = ru_number_to_words(millions) + (
        " миллион" if millions % 10 == 1 and millions % 100 != 11 else " миллионов"
    )
    return f"{word} {ru_number_to_words(rest)}" if rest else word


# -----------------------------------------------------------------------------
# Swedish

_SV_ONES = [
    "noll", "ett", "två", "tre", "fyra", "fem", "sex", "sju", "åtta",
    "nio", "tio", "elva", "tolv", "tretton", "fjorton", "femton",
    "sexton", "sjutton", "arton", "nitton",
]
_SV_TENS = [
    "", "", "tjugo", "trettio", "fyrtio", "femtio", "sextio", "sjuttio",
    "åttio", "nittio",
]


def sv_number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + sv_number_to_words(-n)
    if n < 20:
        return _SV_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _SV_TENS[tens] + (_SV_ONES[rest] if rest else "")
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = ("ett" if hundreds == 1 else _SV_ONES[hundreds]) + "hundra"
        return word + (sv_number_to_words(rest) if rest else "")
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        # "ett" + "tusen" elides one t in writing: ettusen (likewise
        # tjugoettusen for 21000)
        head = "ett" if thousands == 1 else sv_number_to_words(thousands)
        prefix = (head[:-1] if head.endswith("tt") else head) + "tusen"
        return prefix + (" " + sv_number_to_words(rest) if rest else "")
    millions, rest = divmod(n, 10**6)
    word = (
        "en miljon" if millions == 1 else sv_number_to_words(millions) + " miljoner"
    )
    return f"{word} {sv_number_to_words(rest)}" if rest else word


# -----------------------------------------------------------------------------
# Swahili

_SW_ONES = [
    "sifuri", "moja", "mbili", "tatu", "nne", "tano", "sita", "saba",
    "nane", "tisa",
]
_SW_TENS = [
    "", "kumi", "ishirini", "thelathini", "arobaini", "hamsini",
    "sitini", "sabini", "themanini", "tisini",
]


def sw_number_to_words(n: int) -> str:
    if n < 0:
        return "kasoro " + sw_number_to_words(-n)
    if n < 10:
        return _SW_ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        word = _SW_TENS[tens]
        return f"{word} na {_SW_ONES[rest]}" if rest else word
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        word = f"mia {_SW_ONES[hundreds]}"
        return f"{word} na {sw_number_to_words(rest)}" if rest else word
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        word = f"elfu {sw_number_to_words(thousands)}"
        return f"{word} na {sw_number_to_words(rest)}" if rest else word
    millions, rest = divmod(n, 10**6)
    word = f"milioni {sw_number_to_words(millions)}"
    return f"{word} na {sw_number_to_words(rest)}" if rest else word


# -----------------------------------------------------------------------------

NUMBER_TO_WORDS: typing.Dict[str, typing.Callable[[int], str]] = {
    "en-us": en_number_to_words,
    "de-de": de_number_to_words,
    "es-es": es_number_to_words,
    "fr-fr": fr_number_to_words,
    "it-it": it_number_to_words,
    "nl": nl_number_to_words,
    "ru-ru": ru_number_to_words,
    "sv-se": sv_number_to_words,
    "sw": sw_number_to_words,
}

def de_ordinal_to_words(n: int) -> str:
    # the suffix (and the erste/dritte/... specials) attach to the FINAL
    # element of a compound: 103 -> hundertdritte, not *hundertdreiste
    special = {1: "erste", 3: "dritte", 7: "siebte", 8: "achte"}
    if n in special:
        return special[n]
    rest = n % 100
    if n != rest and 0 < rest < 20:
        return de_number_to_words(n - rest) + de_ordinal_to_words(rest)
    return de_number_to_words(n) + ("ste" if n >= 20 else "te")


def fr_ordinal_to_words(n: int) -> str:
    if n == 1:
        return "premier"
    card = fr_number_to_words(n)
    if card.endswith("e"):
        card = card[:-1]
    if card.endswith("cinq"):
        card += "u"
    elif card.endswith("neuf"):
        card = card[:-1] + "v"
    return card + "ième"


def es_ordinal_to_words(n: int) -> str:
    table = {
        1: "primero", 2: "segundo", 3: "tercero", 4: "cuarto", 5: "quinto",
        6: "sexto", 7: "séptimo", 8: "octavo", 9: "noveno", 10: "décimo",
    }
    # ordinals past ten are commonly read as cardinals in Spanish
    return table.get(n) or es_number_to_words(n)


def it_ordinal_to_words(n: int) -> str:
    table = {
        1: "primo", 2: "secondo", 3: "terzo", 4: "quarto", 5: "quinto",
        6: "sesto", 7: "settimo", 8: "ottavo", 9: "nono", 10: "decimo",
    }
    if n in table:
        return table[n]
    card = it_number_to_words(n)
    # final vowel drops before -esimo, except the stressed -tre compounds
    # (ventitreesimo)
    if card and card[-1] in "aeio" and not card.endswith(("tre", "tré")):
        card = card[:-1]
    return card.replace("tré", "tre") + "esimo"


def nl_ordinal_to_words(n: int) -> str:
    # like German, the suffix/specials follow the final compound element:
    # 102 -> honderdtweede, 108 -> honderdachtste
    special = {1: "eerste", 3: "derde", 8: "achtste"}
    if n in special:
        return special[n]
    rest = n % 100
    if n != rest and 0 < rest < 20:
        return nl_number_to_words(n - rest) + nl_ordinal_to_words(rest)
    return nl_number_to_words(n) + ("de" if n < 20 else "ste")


def ru_ordinal_to_words(n: int) -> str:
    table = {
        1: "первый", 2: "второй", 3: "третий", 4: "четвёртый", 5: "пятый",
        6: "шестой", 7: "седьмой", 8: "восьмой", 9: "девятый", 10: "десятый",
        11: "одиннадцатый", 12: "двенадцатый", 13: "тринадцатый",
        14: "четырнадцатый", 15: "пятнадцатый", 16: "шестнадцатый",
        17: "семнадцатый", 18: "восемнадцатый", 19: "девятнадцатый",
        20: "двадцатый", 30: "тридцатый", 40: "сороковой",
        50: "пятидесятый", 60: "шестидесятый", 70: "семидесятый",
        80: "восьмидесятый", 90: "девяностый", 100: "сотый",
        1000: "тысячный", 2000: "двухтысячный", 3000: "трёхтысячный",
    }
    if n in table:
        return table[n]
    if 20 < n < 100 and n % 10:
        return ru_number_to_words(n - n % 10) + " " + table[n % 10]
    rest = n % 100
    if n > 100 and 0 < rest:
        # hundreds/thousands read as cardinal, final element ordinalized
        return ru_number_to_words(n - rest) + " " + ru_ordinal_to_words(rest)
    return ru_number_to_words(n)


def sv_ordinal_to_words(n: int) -> str:
    table = {
        1: "första", 2: "andra", 3: "tredje", 4: "fjärde", 5: "femte",
        6: "sjätte", 7: "sjunde", 8: "åttonde", 9: "nionde", 10: "tionde",
        11: "elfte", 12: "tolfte",
    }
    if n in table:
        return table[n]
    if 20 < n < 100 and n % 10:
        # compounds ordinalize the final element: tjugoförsta
        return sv_number_to_words(n - n % 10) + table[n % 10]
    rest = n % 100
    if n > 100 and 0 < rest:
        # hundraförsta, tvåhundratolfte, hundratjugoförsta
        return sv_number_to_words(n - rest) + sv_ordinal_to_words(rest)
    card = sv_number_to_words(n)
    return card + ("nde" if card.endswith("o") else "de")


def sw_ordinal_to_words(n: int) -> str:
    table = {1: "kwanza", 2: "pili"}
    return "wa " + table.get(n, sw_number_to_words(n))


ORDINAL_TO_WORDS = {
    "en-us": en_ordinal_to_words,
    "de-de": de_ordinal_to_words,
    "es-es": es_ordinal_to_words,
    "fr-fr": fr_ordinal_to_words,
    "it-it": it_ordinal_to_words,
    "nl": nl_ordinal_to_words,
    "ru-ru": ru_ordinal_to_words,
    "sv-se": sv_ordinal_to_words,
    "sw": sw_ordinal_to_words,
}

# language-typical written ordinal forms ("1er", "3:e", "2-й", "4º", "5e")
_ORDINAL_FORMS = {
    "fr-fr": re.compile(r"^(\d+)(er|ère|ere|e|ème|eme)$"),
    "es-es": re.compile(r"^(\d+)[ºª°]$"),
    "it-it": re.compile(r"^(\d+)[ºª°]$"),
    "nl": re.compile(r"^(\d+)(e|de|ste)$"),
    "sv-se": re.compile(r"^(\d+):(e|a)$"),
    "ru-ru": re.compile(r"^(\d+)-(й|я|е|го|му|х|ых|ом|ой|м)$"),
    "de-de": re.compile(r"^(\d+)\.$"),
}


_RU_OBLIQUE_TENS = {
    20: "двадцати", 30: "тридцати", 40: "сорока", 50: "пятидесяти",
    60: "шестидесяти", 70: "семидесяти", 80: "восьмидесяти",
    90: "девяноста", 100: "ста",
}
_RU_OBLIQUE_UNITS = {
    1: "одного", 2: "двух", 3: "трёх", 4: "четырёх", 5: "пяти",
    6: "шести", 7: "семи", 8: "восьми", 9: "девяти", 10: "десяти",
    11: "одиннадцати", 12: "двенадцати", 13: "тринадцати",
    14: "четырнадцати", 15: "пятнадцати", 16: "шестнадцати",
    17: "семнадцати", 18: "восемнадцати", 19: "девятнадцати",
}


def _ru_cardinal_oblique(n: int) -> typing.Optional[str]:
    """Genitive/prepositional cardinal for written "3-х лет" forms
    (трёх, двадцати пяти); None outside 1..100."""
    if n in _RU_OBLIQUE_UNITS:
        return _RU_OBLIQUE_UNITS[n]
    if n in _RU_OBLIQUE_TENS:
        return _RU_OBLIQUE_TENS[n]
    if 20 < n < 100:
        tens, unit = (n // 10) * 10, n % 10
        return f"{_RU_OBLIQUE_TENS[tens]} {_RU_OBLIQUE_UNITS[unit]}"
    return None


def _ru_hyphen_ordinal(n: int, suffix: str) -> str:
    """Russian written ordinal with a case tail: 5-й пятый, 2-е второе,
    90-х девяностых, 5-м пятом. The tail determines the adjectival
    ending; третий takes the soft-stem forms (третья, третьих).

    "-х" is ordinal only for decades ("в 90-х годах" девяностых);
    elsewhere it marks the oblique cardinal ("3-х лет" трёх)."""
    if suffix == "х" and not (n % 10 == 0 and 20 <= n <= 100):
        oblique = _ru_cardinal_oblique(n)
        if oblique is not None:
            return oblique
    words = ru_ordinal_to_words(n)
    head, _, last = words.rpartition(" ")
    soft = last.endswith("ий")  # третий
    stem = last[:-2]
    hard = {
        "й": last, "я": stem + "ая", "е": stem + "ое", "го": stem + "ого",
        "му": stem + "ому", "х": stem + "ых", "ых": stem + "ых",
        "м": stem + "ом", "ом": stem + "ом", "ой": stem + "ой",
    }
    soft_map = {
        "й": last, "я": stem + "ья", "е": stem + "ье", "го": stem + "ьего",
        "му": stem + "ьему", "х": stem + "ьих", "ых": stem + "ьих",
        "м": stem + "ьем", "ом": stem + "ьем", "ой": stem + "ьей",
    }
    last = (soft_map if soft else hard).get(suffix, last)
    return f"{head} {last}".strip()


_DECIMAL_POINT = {
    "en-us": "point",
    "de-de": "Komma",
    "es-es": "coma",
    "fr-fr": "virgule",
    "it-it": "virgola",
    "nl": "komma",
    "ru-ru": "запятая",
    "sv-se": "komma",
    "sw": "pointi",
}

# (singular, plural) per language; Russian (singular, paucal, plural)
_CURRENCY: typing.Dict[str, typing.Dict[str, typing.Sequence[str]]] = {
    "$": {
        "en-us": ("dollar", "dollars"), "de-de": ("Dollar", "Dollar"),
        "es-es": ("dólar", "dólares"), "fr-fr": ("dollar", "dollars"),
        "it-it": ("dollaro", "dollari"), "nl": ("dollar", "dollar"),
        "ru-ru": ("доллар", "доллара", "долларов"),
        "sv-se": ("dollar", "dollar"), "sw": ("dola", "dola"),
    },
    "€": {
        "en-us": ("euro", "euros"), "de-de": ("Euro", "Euro"),
        "es-es": ("euro", "euros"), "fr-fr": ("euro", "euros"),
        "it-it": ("euro", "euro"), "nl": ("euro", "euro"),
        "ru-ru": ("евро", "евро", "евро"),
        "sv-se": ("euro", "euro"), "sw": ("euro", "euro"),
    },
    "£": {
        "en-us": ("pound", "pounds"), "de-de": ("Pfund", "Pfund"),
        "es-es": ("libra", "libras"), "fr-fr": ("livre", "livres"),
        "it-it": ("sterlina", "sterline"), "nl": ("pond", "pond"),
        "ru-ru": ("фунт", "фунта", "фунтов"),
        "sv-se": ("pund", "pund"), "sw": ("pauni", "pauni"),
    },
}

# the numeral "one" inflects before a currency noun in several languages
# (de ein Euro, it un dollaro / una sterlina, es un euro / una libra,
# sv en dollar / ett pund, fr une livre)
_CURRENCY_ONE = {
    ("de-de", "$"): "ein", ("de-de", "€"): "ein", ("de-de", "£"): "ein",
    ("it-it", "$"): "un", ("it-it", "€"): "un", ("it-it", "£"): "una",
    ("es-es", "$"): "un", ("es-es", "€"): "un", ("es-es", "£"): "una",
    ("sv-se", "$"): "en", ("sv-se", "€"): "en", ("sv-se", "£"): "ett",
    ("fr-fr", "£"): "une",
}

# sub-unit word for amounts under one unit ($0.99 -> ninety nine cents)
_CENT_WORDS = {
    "en-us": "cents", "de-de": "Cent", "fr-fr": "centimes",
    "es-es": "céntimos", "it-it": "centesimi", "nl": "cent",
    "sv-se": "cent", "ru-ru": "центов", "sw": "senti",
}

_PERCENT = {
    "en-us": "percent", "de-de": "Prozent", "fr-fr": "pour cent",
    "es-es": "por ciento", "it-it": "per cento", "nl": "procent",
    "ru-ru": "процентов", "sv-se": "procent", "sw": "asilimia",
}

_ORDINAL_RE = re.compile(
    r"^(\d{1,3}(?:,\d{3})*|\d+)(st|nd|rd|th)$", re.IGNORECASE
)
_YEAR_RE = re.compile(r"^[12]\d{3}$")
_NUMBER_RE = re.compile(r"^-?\d{1,3}(?:[,.]\d{3})*(?:[.,]\d+)?$|^-?\d+(?:[.,]\d+)?$")
_CURRENCY_AMOUNT = r"\d{1,3}(?:[,.]\d{3})+(?:[.,]\d+)?|\d+(?:[.,]\d+)?"
_CURRENCY_RE = re.compile(r"^([$€£])(" + _CURRENCY_AMOUNT + r")$")
# European suffix notation: 5€, 3,50€
_CURRENCY_SUFFIX_RE = re.compile(r"^(" + _CURRENCY_AMOUNT + r")([$€£])$")
_TIME_RE = re.compile(r"^(\d{1,2}):(\d{2})$")


def de_year_to_words(n: int) -> str:
    """German years 1100-1999 read in hundreds (neunzehnhundert...)."""
    if 1100 <= n <= 1999:
        h, r = divmod(n, 100)
        return de_number_to_words(h) + "hundert" + (
            de_number_to_words(r) if r else ""
        )
    return de_number_to_words(n)


def nl_year_to_words(n: int) -> str:
    """Dutch years 1100-1999 read in hundreds (negentienhonderd...)."""
    if 1100 <= n <= 1999:
        h, r = divmod(n, 100)
        return nl_number_to_words(h) + "honderd" + (
            nl_number_to_words(r) if r else ""
        )
    return nl_number_to_words(n)


def sv_year_to_words(n: int) -> str:
    """Swedish years 1100-1999 read in hundreds (nittonhundra...)."""
    if 1100 <= n <= 1999:
        h, r = divmod(n, 100)
        return sv_number_to_words(h) + "hundra" + (
            sv_number_to_words(r) if r else ""
        )
    return sv_number_to_words(n)


_YEAR_TO_WORDS = {
    "de-de": de_year_to_words,
    "nl": nl_year_to_words,
    "sv-se": sv_year_to_words,
}


# scores/ratios "N:M" that are not clock times (3:2, 1:1000) read the
# colon as the language's score word; ru/nl/sv/sw keep the plain pause
SCORE_WORD = {
    "en-us": "to", "de-de": "zu", "fr-fr": "à", "es-es": "a",
    "it-it": "a",
}

# dimension/multiplication "x" between numbers (4x4, 1920x1080)
_BY_WORD = {
    "en-us": "by", "de-de": "mal", "fr-fr": "par", "es-es": "por",
    "it-it": "per", "nl": "bij", "sv-se": "gånger", "ru-ru": "на",
    "sw": "kwa",
}

_MINUS = {
    "en-us": "minus", "de-de": "minus", "fr-fr": "moins",
    "es-es": "menos", "it-it": "meno", "nl": "min", "sv-se": "minus",
    "ru-ru": "минус", "sw": "hasi",
}

# Month names per language (Russian in the genitive, as dates read them)
MONTH_NAMES = {
    "en-us": ["January", "February", "March", "April", "May", "June",
              "July", "August", "September", "October", "November",
              "December"],
    "de-de": ["Januar", "Februar", "März", "April", "Mai", "Juni",
              "Juli", "August", "September", "Oktober", "November",
              "Dezember"],
    "fr-fr": ["janvier", "février", "mars", "avril", "mai", "juin",
              "juillet", "août", "septembre", "octobre", "novembre",
              "décembre"],
    "es-es": ["enero", "febrero", "marzo", "abril", "mayo", "junio",
              "julio", "agosto", "septiembre", "octubre", "noviembre",
              "diciembre"],
    "it-it": ["gennaio", "febbraio", "marzo", "aprile", "maggio",
              "giugno", "luglio", "agosto", "settembre", "ottobre",
              "novembre", "dicembre"],
    "nl": ["januari", "februari", "maart", "april", "mei", "juni",
           "juli", "augustus", "september", "oktober", "november",
           "december"],
    "ru-ru": ["января", "февраля", "марта", "апреля", "мая", "июня",
              "июля", "августа", "сентября", "октября", "ноября",
              "декабря"],
    "sv-se": ["januari", "februari", "mars", "april", "maj", "juni",
              "juli", "augusti", "september", "oktober", "november",
              "december"],
    "sw": ["Januari", "Februari", "Machi", "Aprili", "Mei", "Juni",
           "Julai", "Agosti", "Septemba", "Oktoba", "Novemba",
           "Desemba"],
}


def _ru_decline_ordinal(words: str, case: str) -> str:
    """Decline the FINAL word of a masculine Russian ordinal phrase.

    case: 'nom' (первый), 'gen' (первого), 'prep' (первом),
    'dat' (первому), 'instr' (первым).
    """
    if case == "nom":
        return words
    head, _, last = words.rpartition(" ")
    if last.endswith("ий"):       # третий -> третьего / третьем / ...
        last = last[:-2] + {
            "gen": "ьего", "prep": "ьем", "dat": "ьему", "instr": "ьим",
        }[case]
    elif last.endswith(("ый", "ой")):
        last = last[:-2] + {
            "gen": "ого", "prep": "ом", "dat": "ому", "instr": "ым",
        }[case]
    return f"{head} {last}".strip()


def ru_day_genitive(day: int) -> str:
    """Day-of-month before a month name: 12 мая -> двенадцатого."""
    return _ru_decline_ordinal(ru_ordinal_to_words(day), "gen")


def ru_year_ordinal(n: int, case: str = "nom") -> str:
    """Russian year as an ordinal phrase: 1999 -> тысяча девятьсот
    девяносто девятый (год), declined for "в ... году" / "... года".

    Year readings drop the "одна" of "одна тысяча"."""
    words = ru_ordinal_to_words(n)
    if words.startswith("одна тысяча"):
        words = words[len("одна "):]
    return _ru_decline_ordinal(words, case)


# Dotted/dashed all-numeric dates (d.m.y / d-m-y), the common written
# style in German, Russian and Dutch. day first; month must be valid.
_NUMERIC_DATE_RE = re.compile(r"^(\d{1,2})[.\-](\d{1,2})[.\-](\d{4})$")


def date_words(
    token: str, lang: str, case: str = "nom"
) -> typing.Optional[str]:
    """Spoken form of a numeric d.m.y date, else None.

    de: ordinal day + month + year in hundreds (case 'dat' after
    am/vom/...: "zwölften Mai", else "zwölfter Mai"); ru: genitive
    date reading (двенадцатого мая ... года); nl: cardinal day +
    month + year.
    """
    m = _NUMERIC_DATE_RE.match(token)
    if not m:
        return None
    day, month, year = int(m.group(1)), int(m.group(2)), int(m.group(3))
    if not (1 <= day <= 31 and 1 <= month <= 12):
        return None
    month_name = MONTH_NAMES[lang][month - 1] if lang in MONTH_NAMES else None
    if month_name is None:
        return None
    if lang == "de-de":
        # strong nominative (Zwölfter Mai), weak after an article
        # (der zwölfte), dative after am/vom/... (am zwölften)
        suffix = {"dat": "n", "nom_weak": ""}.get(case, "r")
        d = de_ordinal_to_words(day) + suffix
        return f"{d} {month_name} {de_year_to_words(year)}"
    if lang == "ru-ru":
        d = _ru_decline_ordinal(ru_ordinal_to_words(day), "gen")
        # двенадцатое -> двенадцатого is the same gen form as masc
        y = ru_year_ordinal(year, "gen")
        return f"{d} {month_name} {y} года"
    if lang == "nl":
        return (
            f"{nl_number_to_words(day)} {month_name} "
            f"{nl_year_to_words(year)}"
        )
    return None


def slash_date_words(
    first: str, second: str, year: str, lang: str
) -> typing.Optional[str]:
    """Spoken form of a slashed numeric date, else None.

    en-us reads m/d/y with the month name, ordinal day and year
    ("3/4/2021" -> "March fourth twenty twenty one" — the reference's
    gruut 2.1 verbalized en dates the same way, fed at
    larynx/__init__.py:71-73).  Other languages write
    d/m/y; reuse their dotted-date reading where one exists.
    """
    if not (
        re.fullmatch(r"\d{1,2}", first)
        and re.fullmatch(r"\d{1,2}", second)
        and re.fullmatch(r"\d{4}", year)
    ):
        return None
    if lang == "en-us":
        month, day = int(first), int(second)
        if not (1 <= month <= 12 and 1 <= day <= 31):
            return None
        return (
            f"{MONTH_NAMES['en-us'][month - 1]} "
            f"{en_ordinal_to_words(day)} {en_year_to_words(int(year))}"
        )
    return date_words(f"{int(first)}.{int(second)}.{year}", lang)


def _spell_number(token: str, lang: str) -> typing.Optional[str]:
    to_words = NUMBER_TO_WORDS.get(lang, en_number_to_words)
    decimal_word = _DECIMAL_POINT.get(lang, "point")

    if token.startswith("-") and len(token) > 1:
        rest = _spell_number(token[1:], lang)
        if rest is not None:
            return f"{_MINUS.get(lang, 'minus')} {rest}"
        return None

    # Strip digit-group separators (1,000 / 1.000 heuristics)
    clean = token
    if re.match(r"^-?\d{1,3}(?:,\d{3})+(?:\.\d+)?$", token):
        clean = token.replace(",", "")
    elif re.match(r"^-?\d{1,3}(?:\.\d{3})+(?:,\d+)?$", token) and lang != "en-us":
        clean = token.replace(".", "").replace(",", ".")
    elif "," in token and lang != "en-us":
        clean = token.replace(",", ".")

    # a leading zero marks a digit string, not a quantity (0123 -> zero
    # one two three; phone extensions, codes) — int() would drop the zero
    if re.match(r"^0\d+$", clean):
        return " ".join(to_words(int(d)) for d in clean)
    if re.match(r"^-?\d+$", clean):
        return to_words(int(clean))
    m = re.match(r"^(-?\d+)\.(\d+)$", clean)
    if m:
        whole = to_words(int(m.group(1)))
        ones = NUMBER_TO_WORDS.get(lang, en_number_to_words)
        digits = " ".join(ones(int(d)) for d in m.group(2))
        return f"{whole} {decimal_word} {digits}"
    return None


def normalize_token(token: str, lang: str = "en-us") -> typing.Optional[str]:
    """Expand one token into words if it is number-like; else None."""
    if not any(ch.isdigit() for ch in token):
        return None

    # explicit interpretation markers ("22_ordinal", "1963_year") — the
    # convention gruut supports and the reference fixtures use
    # (local/en-us/*/samples/test_sentences.txt)
    m = re.match(r"^(\d+)_(ordinal|year|cardinal)$", token)
    if m:
        value, hint = int(m.group(1)), m.group(2)
        if hint == "ordinal":
            ordinal_fn = ORDINAL_TO_WORDS.get(lang)
            if ordinal_fn:
                return ordinal_fn(value)
        if hint == "year":
            if lang == "en-us":
                return en_year_to_words(value)
            year_fn = _YEAR_TO_WORDS.get(lang)
            if year_fn:
                return year_fn(value)
        return _spell_number(str(value), lang)

    if lang == "en-us":
        m = _ORDINAL_RE.match(token)
        if m:
            return en_ordinal_to_words(int(m.group(1).replace(",", "")))
        if _YEAR_RE.match(token):
            return en_year_to_words(int(token))
    else:
        form = _ORDINAL_FORMS.get(lang)
        m = form.match(token) if form else None
        if m:
            if lang == "ru-ru":
                return _ru_hyphen_ordinal(int(m.group(1)), m.group(2))
            return ORDINAL_TO_WORDS[lang](int(m.group(1)))
        # German er-decades: "die 90er" / "in den 90ern" / "die 1990er
        # Jahre" — cardinal (or hundreds-style year) + attached "er(n)"
        if lang == "de-de":
            dm = re.match(r"^(\d{2}|\d{4})er(n?)$", token)
            if dm:
                n = int(dm.group(1))
                base = (
                    _YEAR_TO_WORDS["de-de"](n)
                    if n >= 1000
                    else de_number_to_words(n)
                )
                return base + "er" + dm.group(2)
        # plain 4-digit years read in hundreds where the language does
        # (de neunzehnhundert..., nl negentienhonderd..., sv nittonhundra...)
        if lang in _YEAR_TO_WORDS and _YEAR_RE.match(token):
            return _YEAR_TO_WORDS[lang](int(token))

    # numeric dates (12.05.2021 in de/ru, 12-05-2021 in nl) read with
    # the month name; must beat the version-number branch
    if _NUMERIC_DATE_RE.match(token):
        spoken = date_words(token, lang)
        if spoken is not None:
            return spoken

    # dotted thousands groups (1.000.000 in de/es/it/nl) are numbers,
    # not versions — _spell_number strips the separators
    if lang != "en-us" and re.match(r"^\d{1,3}(?:\.\d{3})+$", token):
        spelled = _spell_number(token, lang)
        if spelled is not None:
            return spelled

    # version numbers (2.0.1): each dotted group read out, joined by the
    # decimal word — the single-decimal pattern in _spell_number cannot
    # match and the token would otherwise be dropped
    if re.match(r"^\d+(?:\.\d+){2,}$", token):
        to_words = NUMBER_TO_WORDS.get(lang, en_number_to_words)
        sep = _DECIMAL_POINT.get(lang, "point")
        return f" {sep} ".join(
            to_words(int(part)) for part in token.split(".")
        )

    # English decades: "the 1980s" / "the 90s"
    if lang == "en-us":
        dm = re.match(r"^(\d{2})?([2-9])0s$", token)
        if dm:
            ties = {
                "2": "twenties", "3": "thirties", "4": "forties",
                "5": "fifties", "6": "sixties", "7": "seventies",
                "8": "eighties", "9": "nineties",
            }[dm.group(2)]
            if dm.group(1):
                return f"{en_number_to_words(int(dm.group(1)))} {ties}"
            return ties

    # dimensions: 4x4 -> four by four, 1920x1080 (also × and lowercase x)
    xm = re.match(r"^(\d+)[x×](\d+)$", token)
    if xm:
        to_words = NUMBER_TO_WORDS.get(lang, en_number_to_words)
        by = _BY_WORD.get(lang, "by")
        return f"{to_words(int(xm.group(1)))} {by} {to_words(int(xm.group(2)))}"

    pm = re.match(r"^(\d+(?:[.,]\d+)?)%$", token)
    if pm:
        spelled = _spell_number(pm.group(1), lang)
        if spelled is not None:
            unit = _PERCENT.get(lang, "percent")
            if lang == "sw":
                return f"{unit} {spelled}"  # asilimia tatu
            return f"{spelled} {unit}"

    m = _CURRENCY_RE.match(token)
    if not m:
        sm = _CURRENCY_SUFFIX_RE.match(token)
        if sm:
            m = sm
            amount, symbol = sm.groups()
        else:
            amount = symbol = None
    else:
        symbol, amount = m.groups()
    if m:
        forms = _CURRENCY.get(symbol, {}).get(lang)
        # strip thousands separators ($1,234.56 / 1.234,56 €) before the
        # cents split; which mark groups thousands is language-dependent
        if re.match(r"^\d{1,3}(?:,\d{3})+(?:\.\d+)?$", amount) and (
            lang == "en-us" or "." in amount
        ):
            amount = amount.replace(",", "")
        elif re.match(r"^\d{1,3}(?:\.\d{3})+(?:,\d+)?$", amount) and (
            lang != "en-us"
        ):
            amount = amount.replace(".", "")
        cents_m = re.match(r"^(\d+)[.,](\d{1,2})$", amount)
        if cents_m and forms:
            # money reading: $3.50 -> three dollars fifty cents,
            # 3,50 € -> drei Euro fünfzig; under one unit the whole
            # part is dropped ($0.99 -> ninety nine cents)
            to_words = NUMBER_TO_WORDS.get(lang, en_number_to_words)
            whole_n = int(cents_m.group(1))
            cents = to_words(int(cents_m.group(2)))
            cent_word = _CENT_WORDS.get(lang, "cents")
            if lang == "en-us" and symbol == "£":
                cent_word = "pence"
            if whole_n == 0:
                return f"{cents} {cent_word}"
            unit = _agreed_form(str(whole_n), forms, lang)
            whole = (
                _CURRENCY_ONE.get((lang, symbol))
                if whole_n == 1 else None
            ) or to_words(whole_n)
            tail = f"{cents} {cent_word}" if lang == "en-us" else cents
            if lang == "sw":  # noun precedes the numeral: dola tano
                return f"{unit} {whole} na senti {cents}"
            return f"{whole} {unit} {tail}"
        if forms:
            unit = _agreed_form(amount, forms, lang)
            if re.fullmatch(r"\d+", amount) and int(amount) == 1:
                one = _CURRENCY_ONE.get((lang, symbol))
                if one:
                    return f"{one} {unit}"
            spelled = _spell_number(amount, lang)
            if spelled is not None:
                if lang == "sw":  # dola tano, euro kumi
                    return f"{unit} {spelled}"
                return f"{spelled} {unit}"
        else:
            spelled = _spell_number(amount, lang)
            if spelled is not None:
                return spelled

    m = _TIME_RE.match(token)
    if m:
        spoken = _time_to_words(int(m.group(1)), int(m.group(2)), lang)
        if spoken is not None:
            return spoken

    return _spell_number(token, lang)


def _ru_agree(n: int, sg: str, paucal: str, pl: str) -> str:
    """Russian noun form agreeing with numeral n (1 час, 2 часа, 5 часов)."""
    if 11 <= n % 100 <= 14:
        return pl
    last = n % 10
    if last == 1:
        return sg
    if 2 <= last <= 4:
        return paucal
    return pl


def _agreed_form(amount: str, forms: typing.Sequence[str], lang: str) -> str:
    """Pick the unit-noun form agreeing with a raw amount token.

    ``forms`` is (singular, plural) — or (singular, paucal, plural) for
    Russian, where a decimal amount takes the paucal/genitive-singular
    ("2,5 километра").
    """
    amt = amount.lstrip("-")
    is_decimal = not re.fullmatch(r"\d+", amt)
    if lang == "ru-ru" and len(forms) == 3:
        if is_decimal:
            return forms[1]
        return _ru_agree(int(amt), *forms)
    if is_decimal:
        return forms[-1]
    return forms[0] if int(amt) == 1 else forms[-1]


# Degree sign after a number ("25°", "25°C"). Russian carries the
# case triple; Swahili reads the unit BEFORE the number (nyuzi joto 25).
_DEGREE_WORDS: typing.Dict[str, typing.Sequence[str]] = {
    "en-us": ("degree", "degrees"),
    "de-de": ("Grad", "Grad"),
    "fr-fr": ("degré", "degrés"),
    "es-es": ("grado", "grados"),
    "it-it": ("grado", "gradi"),
    "nl": ("graad", "graden"),
    "sv-se": ("grad", "grader"),
    "ru-ru": ("градус", "градуса", "градусов"),
    "sw": ("nyuzi joto", "nyuzi joto"),
}

_DEGREE_SCALE = {
    "C": {
        "en-us": "Celsius", "de-de": "Celsius", "fr-fr": "Celsius",
        "es-es": "Celsius", "it-it": "Celsius", "nl": "Celsius",
        "sv-se": "Celsius", "ru-ru": "Цельсия", "sw": "selsiasi",
    },
    "F": {
        "en-us": "Fahrenheit", "de-de": "Fahrenheit",
        "fr-fr": "Fahrenheit", "es-es": "Fahrenheit",
        "it-it": "Fahrenheit", "nl": "Fahrenheit", "sv-se": "Fahrenheit",
        "ru-ru": "Фаренгейта", "sw": "farenheiti",
    },
}


def degree_tokens(
    amount: str, scale: typing.Optional[str], lang: str
) -> typing.Optional[typing.List[str]]:
    """Replacement tokens for ``amount ° [C|F]`` (number token kept raw)."""
    forms = _DEGREE_WORDS.get(lang)
    if forms is None:
        return None
    unit = _agreed_form(amount, forms, lang)
    tail = _DEGREE_SCALE.get(scale or "", {}).get(lang) if scale else None
    if lang == "sw":  # nyuzi joto 25 (unit precedes the number)
        toks = unit.split() + [amount]
    else:
        toks = [amount] + unit.split()
    if tail:
        toks.append(tail)
    return toks


# Measurement-unit abbreviations read out when they follow a number.
# Only unambiguous abbreviations are listed (no bare m/g/l/s/h/in).
# Values are (singular, plural); Russian (singular, paucal, plural).
_UNIT_WORDS: typing.Dict[str, typing.Dict[str, typing.Sequence[str]]] = {
    "km": {
        "en-us": ("kilometer", "kilometers"),
        "de-de": ("Kilometer", "Kilometer"),
        "fr-fr": ("kilomètre", "kilomètres"),
        "es-es": ("kilómetro", "kilómetros"),
        "it-it": ("chilometro", "chilometri"),
        "nl": ("kilometer", "kilometer"),
        "sv-se": ("kilometer", "kilometer"),
        "ru-ru": ("километр", "километра", "километров"),
        "sw": ("kilomita", "kilomita"),
    },
    "cm": {
        "en-us": ("centimeter", "centimeters"),
        "de-de": ("Zentimeter", "Zentimeter"),
        "fr-fr": ("centimètre", "centimètres"),
        "es-es": ("centímetro", "centímetros"),
        "it-it": ("centimetro", "centimetri"),
        "nl": ("centimeter", "centimeter"),
        "sv-se": ("centimeter", "centimeter"),
        "ru-ru": ("сантиметр", "сантиметра", "сантиметров"),
        "sw": ("sentimita", "sentimita"),
    },
    "mm": {
        "en-us": ("millimeter", "millimeters"),
        "de-de": ("Millimeter", "Millimeter"),
        "fr-fr": ("millimètre", "millimètres"),
        "es-es": ("milímetro", "milímetros"),
        "it-it": ("millimetro", "millimetri"),
        "nl": ("millimeter", "millimeter"),
        "sv-se": ("millimeter", "millimeter"),
        "ru-ru": ("миллиметр", "миллиметра", "миллиметров"),
        "sw": ("milimita", "milimita"),
    },
    "kg": {
        "en-us": ("kilogram", "kilograms"),
        "de-de": ("Kilogramm", "Kilogramm"),
        "fr-fr": ("kilogramme", "kilogrammes"),
        "es-es": ("kilogramo", "kilogramos"),
        "it-it": ("chilogrammo", "chilogrammi"),
        "nl": ("kilogram", "kilogram"),
        "sv-se": ("kilogram", "kilogram"),
        "ru-ru": ("килограмм", "килограмма", "килограммов"),
        "sw": ("kilogramu", "kilogramu"),
    },
    "mg": {
        "en-us": ("milligram", "milligrams"),
        "de-de": ("Milligramm", "Milligramm"),
        "fr-fr": ("milligramme", "milligrammes"),
        "es-es": ("miligramo", "miligramos"),
        "it-it": ("milligrammo", "milligrammi"),
        "nl": ("milligram", "milligram"),
        "sv-se": ("milligram", "milligram"),
        "ru-ru": ("миллиграмм", "миллиграмма", "миллиграммов"),
        "sw": ("miligramu", "miligramu"),
    },
    "ml": {
        "en-us": ("milliliter", "milliliters"),
        "de-de": ("Milliliter", "Milliliter"),
        "fr-fr": ("millilitre", "millilitres"),
        "es-es": ("mililitro", "mililitros"),
        "it-it": ("millilitro", "millilitri"),
        "nl": ("milliliter", "milliliter"),
        "sv-se": ("milliliter", "milliliter"),
        "ru-ru": ("миллилитр", "миллилитра", "миллилитров"),
        "sw": ("mililita", "mililita"),
    },
    "ms": {
        "en-us": ("millisecond", "milliseconds"),
        "de-de": ("Millisekunde", "Millisekunden"),
        "fr-fr": ("milliseconde", "millisecondes"),
        "es-es": ("milisegundo", "milisegundos"),
        "it-it": ("millisecondo", "millisecondi"),
        "nl": ("milliseconde", "milliseconden"),
        "sv-se": ("millisekund", "millisekunder"),
        "ru-ru": ("миллисекунда", "миллисекунды", "миллисекунд"),
        "sw": ("milisekunde", "milisekunde"),
    },
    "min": {
        "en-us": ("minute", "minutes"),
        "de-de": ("Minute", "Minuten"),
        "fr-fr": ("minute", "minutes"),
        "es-es": ("minuto", "minutos"),
        "it-it": ("minuto", "minuti"),
        "nl": ("minuut", "minuten"),
        "sv-se": ("minut", "minuter"),
        "ru-ru": ("минута", "минуты", "минут"),
        "sw": ("dakika", "dakika"),
    },
    "kb": {
        "en-us": ("kilobyte", "kilobytes"),
        "de-de": ("Kilobyte", "Kilobyte"),
        "es-es": ("kilobyte", "kilobytes"),
        "it-it": ("kilobyte", "kilobyte"),
        "nl": ("kilobyte", "kilobyte"),
        "sv-se": ("kilobyte", "kilobyte"),
        "ru-ru": ("килобайт", "килобайта", "килобайт"),
    },
    "mb": {
        "en-us": ("megabyte", "megabytes"),
        "de-de": ("Megabyte", "Megabyte"),
        "es-es": ("megabyte", "megabytes"),
        "it-it": ("megabyte", "megabyte"),
        "nl": ("megabyte", "megabyte"),
        "sv-se": ("megabyte", "megabyte"),
        "ru-ru": ("мегабайт", "мегабайта", "мегабайт"),
    },
    "gb": {
        "en-us": ("gigabyte", "gigabytes"),
        "de-de": ("Gigabyte", "Gigabyte"),
        "es-es": ("gigabyte", "gigabytes"),
        "it-it": ("gigabyte", "gigabyte"),
        "nl": ("gigabyte", "gigabyte"),
        "sv-se": ("gigabyte", "gigabyte"),
        "ru-ru": ("гигабайт", "гигабайта", "гигабайт"),
    },
    "tb": {
        "en-us": ("terabyte", "terabytes"),
        "de-de": ("Terabyte", "Terabyte"),
        "es-es": ("terabyte", "terabytes"),
        "it-it": ("terabyte", "terabyte"),
        "nl": ("terabyte", "terabyte"),
        "sv-se": ("terabyte", "terabyte"),
        "ru-ru": ("терабайт", "терабайта", "терабайт"),
    },
    "hz": {
        "en-us": ("hertz", "hertz"),
        "de-de": ("Hertz", "Hertz"),
        "fr-fr": ("hertz", "hertz"),
        "es-es": ("hercio", "hercios"),
        "it-it": ("hertz", "hertz"),
        "nl": ("hertz", "hertz"),
        "sv-se": ("hertz", "hertz"),
        "ru-ru": ("герц", "герца", "герц"),
    },
    "khz": {
        "en-us": ("kilohertz", "kilohertz"),
        "de-de": ("Kilohertz", "Kilohertz"),
        "fr-fr": ("kilohertz", "kilohertz"),
        "es-es": ("kilohercio", "kilohercios"),
        "it-it": ("kilohertz", "kilohertz"),
        "nl": ("kilohertz", "kilohertz"),
        "sv-se": ("kilohertz", "kilohertz"),
        "ru-ru": ("килогерц", "килогерца", "килогерц"),
    },
    "mhz": {
        "en-us": ("megahertz", "megahertz"),
        "de-de": ("Megahertz", "Megahertz"),
        "fr-fr": ("mégahertz", "mégahertz"),
        "es-es": ("megahercio", "megahercios"),
        "it-it": ("megahertz", "megahertz"),
        "nl": ("megahertz", "megahertz"),
        "sv-se": ("megahertz", "megahertz"),
        "ru-ru": ("мегагерц", "мегагерца", "мегагерц"),
    },
    "ghz": {
        "en-us": ("gigahertz", "gigahertz"),
        "de-de": ("Gigahertz", "Gigahertz"),
        "fr-fr": ("gigahertz", "gigahertz"),
        "es-es": ("gigahercio", "gigahercios"),
        "it-it": ("gigahertz", "gigahertz"),
        "nl": ("gigahertz", "gigahertz"),
        "sv-se": ("gigahertz", "gigahertz"),
        "ru-ru": ("гигагерц", "гигагерца", "гигагерц"),
    },
    "mph": {
        "en-us": ("mile per hour", "miles per hour"),
    },
}

# Cyrillic unit abbreviations as they appear in Russian text
for _lat, _cyr in (
    ("km", "км"), ("cm", "см"), ("mm", "мм"), ("kg", "кг"),
    ("mg", "мг"), ("ml", "мл"), ("min", "мин"),
):
    _UNIT_WORDS[_cyr] = {"ru-ru": _UNIT_WORDS[_lat]["ru-ru"]}

# German unit nouns after which the numeral 1 inflects: masculine/neuter
# take "ein" (ein Kilometer, ein Euro), feminine take "eine" (eine
# Minute, eine Stunde)
DE_UNIT_NOUNS_F = {"Minute", "Stunde", "Sekunde", "Millisekunde", "Woche"}
DE_UNIT_NOUNS = (
    {forms["de-de"][0] for forms in _UNIT_WORDS.values() if "de-de" in forms}
    | {"Grad", "Prozent", "Euro", "Dollar", "Pfund", "Cent", "Meter",
       "Liter", "Gramm", "Tag", "Monat", "Jahr"}
    | DE_UNIT_NOUNS_F
)

# "N km/h" — the whole unit phrase, invariant in number
_PER_HOUR = {
    "en-us": "kilometers per hour",
    "de-de": "Kilometer pro Stunde",
    "fr-fr": "kilomètres par heure",
    "es-es": "kilómetros por hora",
    "it-it": "chilometri orari",
    "nl": "kilometer per uur",
    "sv-se": "kilometer i timmen",
    "ru-ru": "километров в час",
    "sw": "kilomita kwa saa",
}


def measure_tokens(
    amount: str, unit: str, lang: str
) -> typing.Optional[typing.List[str]]:
    """Replacement tokens for ``amount unit`` (number token kept raw)."""
    forms = _UNIT_WORDS.get(unit.lower(), {}).get(lang)
    if forms is None:
        return None
    return [amount] + _agreed_form(amount, forms, lang).split()


# Common written fractions: denominator -> per-language (singular,
# plural) fraction noun. Dutch/German fraction nouns are invariant;
# Russian uses the feminine ordinal (одна вторая, три четвёртых).
_FRACTION_WORDS: typing.Dict[int, typing.Dict[str, typing.Sequence[str]]] = {
    2: {
        "en-us": ("half", "halves"), "de-de": ("halb", "halbe"),
        "fr-fr": ("demi", "demis"), "es-es": ("medio", "medios"),
        "it-it": ("mezzo", "mezzi"), "nl": ("half", "half"),
        "sv-se": ("halv", "halva"), "ru-ru": ("вторая", "вторых"),
        "sw": ("nusu", "nusu"),
    },
    3: {
        "en-us": ("third", "thirds"), "de-de": ("Drittel", "Drittel"),
        "fr-fr": ("tiers", "tiers"), "es-es": ("tercio", "tercios"),
        "it-it": ("terzo", "terzi"), "nl": ("derde", "derde"),
        "sv-se": ("tredjedel", "tredjedelar"),
        "ru-ru": ("третья", "третьих"), "sw": ("theluthi", "theluthi"),
    },
    4: {
        "en-us": ("quarter", "quarters"), "de-de": ("Viertel", "Viertel"),
        "fr-fr": ("quart", "quarts"), "es-es": ("cuarto", "cuartos"),
        "it-it": ("quarto", "quarti"), "nl": ("kwart", "kwart"),
        "sv-se": ("fjärdedel", "fjärdedelar"),
        "ru-ru": ("четвёртая", "четвёртых"), "sw": ("robo", "robo"),
    },
    5: {
        "en-us": ("fifth", "fifths"), "de-de": ("Fünftel", "Fünftel"),
        "fr-fr": ("cinquième", "cinquièmes"),
        "es-es": ("quinto", "quintos"), "it-it": ("quinto", "quinti"),
        "nl": ("vijfde", "vijfde"),
        "sv-se": ("femtedel", "femtedelar"),
        "ru-ru": ("пятая", "пятых"),
    },
    8: {
        "en-us": ("eighth", "eighths"), "de-de": ("Achtel", "Achtel"),
        "fr-fr": ("huitième", "huitièmes"),
        "es-es": ("octavo", "octavos"), "it-it": ("ottavo", "ottavi"),
        "nl": ("achtste", "achtste"),
        "sv-se": ("åttondel", "åttondelar"),
        "ru-ru": ("восьмая", "восьмых"),
    },
    10: {
        "en-us": ("tenth", "tenths"), "de-de": ("Zehntel", "Zehntel"),
        "fr-fr": ("dixième", "dixièmes"),
        "es-es": ("décimo", "décimos"), "it-it": ("decimo", "decimi"),
        "nl": ("tiende", "tiende"),
        "sv-se": ("tiondel", "tiondelar"),
        "ru-ru": ("десятая", "десятых"),
    },
}

# numerator word when it is 1 (gendered/reduced articles)
_FRACTION_ONE = {
    "en-us": "one", "de-de": "ein", "fr-fr": "un", "es-es": "un",
    "it-it": "un", "nl": "een", "sv-se": "en", "ru-ru": "одна",
}


def fraction_words(num: int, den: int, lang: str) -> typing.Optional[str]:
    """Spoken form of a simple written fraction like 1/2 or 3/4."""
    forms = _FRACTION_WORDS.get(den, {}).get(lang)
    if forms is None:
        return None
    noun = forms[0] if num == 1 else forms[-1]
    if lang == "sw":  # noun precedes the numeral: robo tatu
        if num == 1:
            return noun
        return f"{noun} {sw_number_to_words(num)}"
    if num == 1:
        one = _FRACTION_ONE.get(lang, "one")
        return f"{one} {noun}"
    if lang == "ru-ru":
        head = "две" if num == 2 else ru_number_to_words(num)
        return f"{head} {noun}"
    to_words = NUMBER_TO_WORDS.get(lang, en_number_to_words)
    return f"{to_words(num)} {noun}"


# Spoken symbol readings ("AT&T", "2+2=4"). & is read wherever it
# joins words; + and = only between alphanumeric neighbors.
SYMBOL_WORDS: typing.Dict[str, typing.Dict[str, str]] = {
    "&": {
        "en-us": "and", "de-de": "und", "fr-fr": "et", "es-es": "y",
        "it-it": "e", "nl": "en", "sv-se": "och", "ru-ru": "и",
        "sw": "na",
    },
    "+": {
        "en-us": "plus", "de-de": "plus", "fr-fr": "plus",
        "es-es": "más", "it-it": "più", "nl": "plus", "sv-se": "plus",
        "ru-ru": "плюс",
    },
    "=": {
        "en-us": "equals", "de-de": "gleich", "fr-fr": "égale",
        "es-es": "igual a", "it-it": "uguale", "nl": "is",
        "sv-se": "är lika med", "ru-ru": "равно",
    },
    "@": {
        "en-us": "at", "de-de": "at", "fr-fr": "arobase",
        "es-es": "arroba", "it-it": "chiocciola", "nl": "apenstaartje",
        "sv-se": "snabel a", "ru-ru": "собака", "sw": "at",
    },
}

# spoken "." inside domain names / email addresses
DOT_WORDS = {
    "en-us": "dot", "de-de": "Punkt", "fr-fr": "point",
    "es-es": "punto", "it-it": "punto", "nl": "punt",
    "sv-se": "punkt", "ru-ru": "точка", "sw": "nukta",
}

_EMAIL_RE = re.compile(r"\b[\w+-]+(?:\.[\w+-]+)*@[A-Za-z][\w-]*(?:\.[\w-]+)+\b")
# Bare domains: lowercase TLD only — a typo'd sentence boundary
# ("Ende.Es war") continues with a capital and must not match
_DOMAIN_RE = re.compile(
    r"\b(?:https?://)?(?:[A-Za-z][\w-]*\.)+"
    r"(?:com|net|org|edu|gov|mil|io|info|biz|app|dev|ai|tv|me|eu|uk"
    r"|de|fr|es|it|nl|se|ru|ch|at|be|co|us|ca|ke|tz)\b(?![\w.@-])"
)


def _spoken_domain(domain: str, lang: str) -> str:
    dot = DOT_WORDS.get(lang, "dot")
    labels = []
    for label in domain.split("."):
        # "www" has no vowels and 2-letter TLDs are spelled, not read:
        # uppercase them so the initialism pass spells the letters in
        # the target language
        if label.lower() == "www" or len(label) <= 2:
            label = label.upper()
        labels.append(label)
    return f" {dot} ".join(labels)


def verbalize_urls(sentence: str, lang: str) -> str:
    """Rewrite email addresses and bare domains into spoken words so
    the domain periods do not become sentence-level pauses."""
    at_word = SYMBOL_WORDS["@"].get(lang, "at")
    plus_word = SYMBOL_WORDS["+"].get(lang, "plus")

    def email_sub(m: "re.Match[str]") -> str:
        local, _, domain = m.group().partition("@")
        dot = DOT_WORDS.get(lang, "dot")
        local = local.replace(".", f" {dot} ").replace("+", f" {plus_word} ")
        return f"{local} {at_word} {_spoken_domain(domain, lang)}"

    def domain_sub(m: "re.Match[str]") -> str:
        bare = re.sub(r"^https?://", "", m.group())
        return _spoken_domain(bare, lang)

    sentence = _EMAIL_RE.sub(email_sub, sentence)
    return _DOMAIN_RE.sub(domain_sub, sentence)

_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}


def roman_to_int(s: str) -> typing.Optional[int]:
    """Strict roman-numeral parse; None if s is not well-formed."""
    if not s or any(ch not in _ROMAN_VALUES for ch in s):
        return None
    total = 0
    prev = 0
    for ch in reversed(s):
        v = _ROMAN_VALUES[ch]
        if v < prev:
            total -= v
        else:
            total += v
            prev = v
    # round-trip check rejects malformed spellings like IIII or IXI
    digits = [
        (1000, "M"), (900, "CM"), (500, "D"), (400, "CD"), (100, "C"),
        (90, "XC"), (50, "L"), (40, "XL"), (10, "X"), (9, "IX"),
        (5, "V"), (4, "IV"), (1, "I"),
    ]
    n, out = total, []
    for val, sym in digits:
        while n >= val:
            out.append(sym)
            n -= val
    return total if "".join(out) == s else None


def kmh_tokens(amount: str, lang: str) -> typing.Optional[typing.List[str]]:
    """Replacement tokens for ``amount km/h`` (number token kept raw)."""
    phrase = _PER_HOUR.get(lang)
    if phrase is None:
        return None
    return [amount] + phrase.split()


UNIT_ABBREVIATIONS = frozenset(_UNIT_WORDS)

# Words that put a following roman numeral in ordinal-series position
# ("Chapter IV", "Kapitel IV", "siglo XXI") — read as a cardinal.
_ROMAN_CONTEXT = {
    "en-us": {
        "chapter", "part", "act", "scene", "section", "volume", "book",
        "phase", "stage", "article", "appendix", "level", "war",
        "grade", "class", "type", "title",
    },
    "de-de": {"kapitel", "teil", "akt", "band", "artikel", "weltkrieg"},
    "fr-fr": {
        "chapitre", "partie", "acte", "tome", "article", "scène",
        "livre", "guerre",
    },
    "es-es": {
        "capítulo", "parte", "acto", "tomo", "artículo", "siglo",
        "libro", "guerra",
    },
    "it-it": {"capitolo", "parte", "atto", "tomo", "articolo", "libro"},
    "nl": {"hoofdstuk", "deel", "akte", "artikel", "boek"},
    "sv-se": {"kapitel", "del", "akt", "artikel", "bok"},
    "ru-ru": {"глава", "часть", "том", "акт"},
}

# Regnal/papal names: "Henry VIII" -> "Henry the eighth". Each language
# has its own reading convention (gruut punts on all of them):
#   en: "the" + ordinal            de: der/die + ordinal (nominative)
#   fr: cardinal, except premier   es: ordinal <= 10, cardinal above
#   it: plain ordinal              nl: "de" + ordinal
#   sv: "den" + ordinal            ru: ordinal, gender-agreeing
_EN_REGNAL = {
    "henry", "louis", "george", "edward", "charles", "james",
    "william", "elizabeth", "richard", "philip", "frederick",
    "alexander", "napoleon", "catherine", "mary", "anne", "john",
    "paul", "benedict", "pius", "leo", "gregory", "urban", "innocent",
    "clement", "nicholas", "ivan", "peter", "gustav", "carl", "olaf",
    "juan", "felipe", "pedro", "umberto", "wilhelm", "ludwig", "otto",
    "karl", "christian", "ramses", "ptolemy", "darius", "king",
    "queen", "pope", "tsar", "emperor", "kaiser",
}

# Shared masculine monarch/pope first names as they appear across the
# eight non-English languages (lowercased, diacritics kept).
_REGNAL_M = _EN_REGNAL | {
    "heinrich", "friedrich", "georg", "johann", "franz", "maximilian",
    "henri", "françois", "philippe", "napoléon", "charles",
    "carlos", "alfonso", "fernando", "francisco",
    "enrico", "carlo", "vittorio", "emanuele", "ferdinando",
    "federico", "francesco", "giovanni", "paolo", "benedetto",
    "pio", "leone", "gregorio", "urbano", "innocenzo", "clemente",
    "willem", "karel", "filips", "frederik",
    "johan", "fredrik", "erik", "oscar", "oskar", "magnus", "håkan",
    "harald", "olav", "kristian",
    "пётр", "петр", "николай", "александр", "иван", "павел",
    "алексей", "михаил", "фёдор", "борис", "людовик", "карл",
    "генрих", "георг", "вильгельм", "наполеон", "филипп",
    "franziskus", "johannes", "benedikt", "benedicto", "benoît",
    "léon", "pie", "клим",
}

# Feminine names take the feminine ordinal in de/es/it/ru (and the
# feminine article in fr for "première").
_REGNAL_F = {
    "elizabeth", "elisabeth", "elisabetta", "isabel", "isabelle",
    "catherine", "katharina", "catalina", "caterina", "екатерина",
    "mary", "maria", "marie", "мария", "anne", "anna", "анна",
    "victoria", "viktoria", "виктория", "christina", "kristina",
    "juliana", "wilhelmina", "beatrix", "margrethe", "margareta",
    "juana", "елизавета", "margarethe", "élisabeth", "catarina",
    "queen", "königin", "kaiserin", "reine", "impératrice", "reina",
    "emperatriz", "regina", "imperatrice", "koningin", "keizerin",
    "drottning", "kejsarinna", "царица", "королева", "императрица",
}

# Masculine title words (per-language) that also trigger regnal reading
_REGNAL_M |= {
    "könig", "papst", "zar", "roi", "pape", "empereur", "rey", "papa",
    "emperador", "re", "imperatore", "koning", "paus", "tsaar",
    "keizer", "kung", "påve", "kejsare", "царь", "король", "папа",
    "император",
}


def _regnal_words(value: int, fem: bool, lang: str) -> typing.Optional[str]:
    """Language-specific spoken form of a regnal number."""
    if lang == "en-us":
        return f"the {en_ordinal_to_words(value)}"
    if lang == "de-de":
        return ("die " if fem else "der ") + de_ordinal_to_words(value)
    if lang == "fr-fr":
        if value == 1:
            return "première" if fem else "premier"
        return fr_number_to_words(value)
    if lang == "es-es":
        word = es_ordinal_to_words(value)
        if fem and value <= 10:
            word = word[:-1] + "a"
        return word
    if lang == "it-it":
        word = it_ordinal_to_words(value)
        if fem:
            word = word[:-1] + "a"
        return word
    if lang == "nl":
        return "de " + nl_ordinal_to_words(value)
    if lang == "sv-se":
        return "den " + sv_ordinal_to_words(value)
    if lang == "ru-ru":
        word = ru_ordinal_to_words(value)
        if fem:
            if word.endswith("ий"):       # третий -> третья
                word = word[:-2] + "ья"
            elif word.endswith(("ый", "ой")):
                word = word[:-2] + "ая"   # первый/второй -> первая/вторая
        return word
    return None


# Declined (oblique-case) forms of the Russian regnal names: "о Петре I"
# must read "о Петре Первом" — the case of the matched name form carries
# to the regnal ordinal.  Value: (case key, feminine).  Feminine oblique
# adjectives share one form (первой), so ы/е/ой all map to 'obl'.
_RU_REGNAL_DECLINED: typing.Dict[str, typing.Tuple[str, bool]] = {}


def _build_ru_regnal_declensions() -> None:
    masc = [
        "пётр", "петр", "николай", "александр", "иван", "павел",
        "алексей", "михаил", "фёдор", "федор", "борис", "людовик",
        "карл", "генрих", "георг", "вильгельм", "наполеон", "филипп",
        "царь", "король", "император", "лев",
    ]
    fem = [
        "екатерина", "мария", "анна", "виктория", "елизавета",
        "царица", "королева", "императрица",
    ]
    for name in masc:
        if name == "павел":        # fleeting vowel
            stem = "павл"
        elif name == "лев":
            stem = "льв"
        elif name.endswith(("й", "ь")):
            stem = name[:-1]
        else:
            stem = name
        soft = name.endswith(("й", "ь"))   # лев is hard: льва, львом
        endings = (
            {"я": "gen", "ю": "dat", "ем": "instr", "ём": "instr",
             "е": "prep"}
            if soft
            else {"а": "gen", "у": "dat", "ом": "instr", "е": "prep"}
        )
        for end, case in endings.items():
            _RU_REGNAL_DECLINED.setdefault(stem + end, (case, False))
    for name in fem:
        stem = name[:-1]
        if name.endswith("ия"):            # мария -> марии/марией/марию
            pairs = (("и", "obl"), ("ей", "obl"), ("ю", "acc"))
        elif stem.endswith(("ц", "ж", "ч", "ш", "щ")):
            # sibilant/ц stems: unstressed instr -ей (царицей), gen -ы
            pairs = (
                ("ы", "obl"), ("е", "obl"), ("ей", "obl"), ("у", "acc"),
            )
        else:
            pairs = (
                ("ы", "obl"), ("е", "obl"), ("ой", "obl"), ("у", "acc"),
            )
        for end, case in pairs:
            _RU_REGNAL_DECLINED.setdefault(stem + end, (case, True))


_build_ru_regnal_declensions()


def _ru_regnal_declined_words(value: int, case: str, fem: bool) -> str:
    """Regnal ordinal agreeing with a declined Russian name form."""
    word = ru_ordinal_to_words(value)
    if not fem:
        return _ru_decline_ordinal(word, case)
    # feminine: build the nominative (первая/третья), then decline
    if word.endswith("ий"):
        nom, obl, acc = word[:-2] + "ья", word[:-2] + "ьей", word[:-2] + "ью"
    else:
        nom, obl, acc = word[:-2] + "ая", word[:-2] + "ой", word[:-2] + "ую"
    return {"obl": obl, "acc": acc}.get(case, nom)


# roman numeral BEFORE a century noun reads as an ordinal, declined to
# the noun's case in Russian ("в XIX веке" -> девятнадцатом)
_ROMAN_CENTURY_NEXT = {
    "ru-ru": {
        "век": "nom", "века": "gen", "веке": "prep", "веку": "dat",
        "веков": "gen", "столетие": "nom", "столетия": "gen",
        "столетии": "prep", "столетию": "dat",
    },
    "it-it": {"secolo": "nom", "secoli": "nom", "millennio": "nom"},
}


def roman_words(
    prev_word: str, token: str, lang: str, next_word: str = ""
) -> typing.Optional[str]:
    """Spoken form of a roman numeral in a reading context, else None.

    Keyword contexts ("Chapter IV", "siglo XXI") read as cardinals in
    every language; regnal names ("Henry VIII", "Wilhelm II.",
    "Екатерина II") read in each language's convention (see
    `_regnal_words`). A century noun AFTER the numeral ("XIX веке",
    "XX secolo") reads it as an ordinal, declined in Russian. Single
    letters are only read after a keyword or regnal name, and only
    I/V/X — "Appendix C" keeps the letter C. In English the bare "I"
    is never read (pronoun collision: "George I was saying");
    elsewhere "Пётр I"/"Karl V." are the common style.
    """
    nxt_case = _ROMAN_CENTURY_NEXT.get(lang, {}).get(next_word.lower())
    if nxt_case is not None and token.isupper():
        value = roman_to_int(token)
        if value is not None and 1 <= value <= 30 and (
            len(token) >= 2 or token in ("I", "V", "X")
        ):
            if lang == "ru-ru":
                return _ru_decline_ordinal(
                    ru_ordinal_to_words(value), nxt_case
                )
            return it_ordinal_to_words(value)
    prev = prev_word.lower().rstrip(".")
    if lang == "fr-fr" and token in ("Ier", "Ière", "1er"):
        # the standard written style for "premier": François Ier
        if prev in _REGNAL_F or prev in _REGNAL_M:
            return "première" if token == "Ière" else "premier"
        return None
    if not token.isupper():
        return None
    value = roman_to_int(token)
    if value is None or value > 2200:
        return None
    if prev in _ROMAN_CONTEXT.get(lang, ()):
        if len(token) == 1 and token not in ("I", "V", "X"):
            return None
        to_words = NUMBER_TO_WORDS.get(lang)
        return to_words(value) if to_words else None
    if 1 <= value <= 30:
        fem = prev in _REGNAL_F
        declined = (
            _RU_REGNAL_DECLINED.get(prev)
            if lang == "ru-ru" and not (fem or prev in _REGNAL_M)
            else None
        )
        if not (fem or prev in _REGNAL_M or declined):
            return None
        if len(token) == 1 and (
            token not in ("I", "V", "X")
            or (lang == "en-us" and token == "I")
        ):
            return None
        if declined is not None:
            return _ru_regnal_declined_words(value, *declined)
        return _regnal_words(value, fem, lang)
    return None


def _ru_hour_noun(hours: int) -> str:
    """часов/часа/час agreeing with the hour numeral (7 часов, 2 часа)."""
    last = hours % 10
    if 11 <= hours % 100 <= 14:
        return "часов"
    if last == 1:
        return "час"
    if 2 <= last <= 4:
        return "часа"
    return "часов"


def time_words(hours: int, minutes: int, lang: str) -> typing.Optional[str]:
    """Public clock reading ("21 h 30" written style uses it too)."""
    return _time_to_words(hours, minutes, lang)


def _time_to_words(hours: int, minutes: int, lang: str) -> typing.Optional[str]:
    """Digital clock time -> words, per-language reading conventions."""
    if lang == "en-us":
        w = en_number_to_words
        if minutes == 0:
            return f"{w(hours)} o'clock"
        if minutes < 10:
            return f"{w(hours)} oh {w(minutes)}"
        return f"{w(hours)} {w(minutes)}"
    to_words = NUMBER_TO_WORDS.get(lang)
    if to_words is None:
        return None
    h, mnt = to_words(hours), to_words(minutes)
    if lang == "de-de":
        h = "ein" if hours == 1 else h  # ein Uhr, not eins Uhr
        return f"{h} Uhr" if minutes == 0 else f"{h} Uhr {mnt}"
    if lang == "nl":
        return f"{h} uur" if minutes == 0 else f"{h} uur {mnt}"
    if lang == "fr-fr":
        if hours % 10 == 1 and hours != 11:
            h = re.sub(r"un$", "une", h)  # vingt et UNE heures
        heure = "une heure" if hours == 1 else f"{h} heures"
        if hours == 0:
            heure = "zéro heure"
        return heure if minutes == 0 else f"{heure} {mnt}"
    if lang == "es-es":
        h = "una" if hours == 1 else h
        return f"{h} en punto" if minutes == 0 else f"{h} y {mnt}"
    if lang == "it-it":
        h = "una" if hours == 1 else h
        return f"{h} in punto" if minutes == 0 else f"{h} e {mnt}"
    if lang == "sv-se":
        if minutes == 0:
            return f"klockan {h}"
        return f"{h} noll {mnt}" if minutes < 10 else f"{h} {mnt}"
    if lang == "ru-ru":
        if minutes == 0:
            return f"{h} {_ru_hour_noun(hours)}"
        return f"{h} ноль {mnt}" if minutes < 10 else f"{h} {mnt}"
    if lang == "sw":
        return f"saa {h}" if minutes == 0 else f"saa {h} na dakika {mnt}"
    return f"{h} {mnt}"
