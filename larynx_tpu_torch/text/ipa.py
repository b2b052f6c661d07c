# Copied from larynx_tpu/text/ipa.py; only the package name in its imports differs.
"""IPA phoneme descriptions: articulatory features, examples, inventories.

In-tree replacement for the slice of ``gruut_ipa`` the reference HTTP
server uses (larynx/server.py:386-438): classify a phoneme string into
vowel / consonant / diphthong features, attach an example word, and derive
a stable file stem for example audio.  Per-language inventories mirror the
released voices' ``phonemes.txt`` tables
(``local/<lang>/<voice>/phonemes.txt`` in the reference checkout).

Unlike the reference (which shipped third-party recordings and guessed
their file names from features), example audio here is *synthesized* from
the same feature bundles by :mod:`larynx_tpu.dsp.ipa_synth`.
"""

import dataclasses
import typing
import unicodedata

# --- feature tables ------------------------------------------------------------

# base vowel letter -> (height, backness, rounded)
VOWELS: typing.Dict[str, typing.Tuple[str, str, bool]] = {
    "i": ("close", "front", False),
    "y": ("close", "front", True),
    "ɨ": ("close", "central", False),
    "ʉ": ("close", "central", True),
    "ɯ": ("close", "back", False),
    "u": ("close", "back", True),
    "ɪ": ("near-close", "front", False),
    "ʏ": ("near-close", "front", True),
    "ʊ": ("near-close", "back", True),
    "e": ("close-mid", "front", False),
    "ø": ("close-mid", "front", True),
    "ɘ": ("close-mid", "central", False),
    "ɵ": ("close-mid", "central", True),
    "ɤ": ("close-mid", "back", False),
    "o": ("close-mid", "back", True),
    "ə": ("mid", "central", False),
    "ɚ": ("mid", "central", False),  # r-coloured, flagged below
    "ɛ": ("open-mid", "front", False),
    "œ": ("open-mid", "front", True),
    "ɜ": ("open-mid", "central", False),
    "ʌ": ("open-mid", "back", False),
    "ɔ": ("open-mid", "back", True),
    "æ": ("near-open", "front", False),
    "ɐ": ("near-open", "central", False),
    "a": ("open", "front", False),
    "ɶ": ("open", "front", True),
    "ɑ": ("open", "back", False),
    "ɒ": ("open", "back", True),
}

# base consonant -> (voiced, place, manner)
CONSONANTS: typing.Dict[str, typing.Tuple[bool, str, str]] = {
    "p": (False, "bilabial", "plosive"),
    "b": (True, "bilabial", "plosive"),
    "t": (False, "alveolar", "plosive"),
    "d": (True, "alveolar", "plosive"),
    "ʈ": (False, "retroflex", "plosive"),
    "ɖ": (True, "retroflex", "plosive"),
    "c": (False, "palatal", "plosive"),
    "ɟ": (True, "palatal", "plosive"),
    "k": (False, "velar", "plosive"),
    "g": (True, "velar", "plosive"),
    "ɡ": (True, "velar", "plosive"),
    "q": (False, "uvular", "plosive"),
    "ʔ": (False, "glottal", "plosive"),
    "m": (True, "bilabial", "nasal"),
    "ɱ": (True, "labiodental", "nasal"),
    "n": (True, "alveolar", "nasal"),
    "ɲ": (True, "palatal", "nasal"),
    "ŋ": (True, "velar", "nasal"),
    "ʙ": (True, "bilabial", "trill"),
    "r": (True, "alveolar", "trill"),
    "ʀ": (True, "uvular", "trill"),
    "ɾ": (True, "alveolar", "flap"),
    "ɽ": (True, "retroflex", "flap"),
    "ɸ": (False, "bilabial", "fricative"),
    "β": (True, "bilabial", "fricative"),
    "f": (False, "labiodental", "fricative"),
    "v": (True, "labiodental", "fricative"),
    "θ": (False, "dental", "fricative"),
    "ð": (True, "dental", "fricative"),
    "s": (False, "alveolar", "fricative"),
    "z": (True, "alveolar", "fricative"),
    "ʃ": (False, "postalveolar", "fricative"),
    "ʒ": (True, "postalveolar", "fricative"),
    "ʂ": (False, "retroflex", "fricative"),
    "ʐ": (True, "retroflex", "fricative"),
    "ɕ": (False, "alveolopalatal", "fricative"),
    "ʑ": (True, "alveolopalatal", "fricative"),
    "ç": (False, "palatal", "fricative"),
    "ʝ": (True, "palatal", "fricative"),
    "x": (False, "velar", "fricative"),
    "ɣ": (True, "velar", "fricative"),
    "χ": (False, "uvular", "fricative"),
    "ʁ": (True, "uvular", "fricative"),
    "ħ": (False, "pharyngeal", "fricative"),
    "h": (False, "glottal", "fricative"),
    "ɦ": (True, "glottal", "fricative"),
    "ɧ": (False, "postalveolar-velar", "fricative"),  # Swedish sj-sound
    "ʋ": (True, "labiodental", "approximant"),
    "ɹ": (True, "alveolar", "approximant"),
    "ɻ": (True, "retroflex", "approximant"),
    "j": (True, "palatal", "approximant"),
    "ɰ": (True, "velar", "approximant"),
    "w": (True, "labiovelar", "approximant"),
    "ɥ": (True, "labiopalatal", "approximant"),
    "l": (True, "alveolar", "lateral-approximant"),
    "ʎ": (True, "palatal", "lateral-approximant"),
    "ʟ": (True, "velar", "lateral-approximant"),
    "ɓ": (True, "bilabial", "implosive"),
    "ɗ": (True, "alveolar", "implosive"),
    "ʄ": (True, "palatal", "implosive"),
    "ɠ": (True, "velar", "implosive"),
}

# multi-char affricates (tie bar U+0361 or plain digraph) -> features
AFFRICATES: typing.Dict[str, typing.Tuple[bool, str, str]] = {
    "t͡s": (False, "alveolar", "affricate"),
    "d͡z": (True, "alveolar", "affricate"),
    "t͡ʃ": (False, "postalveolar", "affricate"),
    "d͡ʒ": (True, "postalveolar", "affricate"),
    "t͡ɕ": (False, "alveolopalatal", "affricate"),
    "d͡ʑ": (True, "alveolopalatal", "affricate"),
    "p͡f": (False, "labiodental", "affricate"),
    "ɗ͡ʒ": (True, "postalveolar", "affricate"),  # Swahili implosive onset
    "ts": (False, "alveolar", "affricate"),
    "dz": (True, "alveolar", "affricate"),
    "tʃ": (False, "postalveolar", "affricate"),
    "dʒ": (True, "postalveolar", "affricate"),
    "pf": (False, "labiodental", "affricate"),
}

_LONG = "ː"
_PALATALIZED = "ʲ"
_ASPIRATED = "ʰ"
_NASALIZED = "̃"  # combining tilde
_NON_SYLLABIC = "̯"  # combining inverted breve below
_TIE = "͡"
_PRENASAL = {"ᵐ": "m", "ⁿ": "n", "ᵑ": "ŋ", "ᶬ": "ɱ"}

# en-us example words keyed by phoneme (reference parity: gruut_ipa carried
# a per-language example per phoneme; other languages fall back to the
# articulatory description)
EXAMPLES_EN: typing.Dict[str, str] = {
    "p": "pay", "b": "bee", "t": "tea", "d": "day", "k": "key", "ɡ": "go",
    "t͡ʃ": "chin", "d͡ʒ": "joy", "f": "fee", "v": "view", "θ": "think",
    "ð": "this", "s": "see", "z": "zoo", "ʃ": "she", "ʒ": "measure",
    "h": "hat", "m": "me", "n": "no", "ŋ": "sing", "l": "lay", "ɹ": "red",
    "j": "yes", "w": "we", "i": "see", "ɪ": "sit", "eɪ": "say", "ɛ": "bed",
    "æ": "cat", "ɑ": "father", "ɔ": "law", "oʊ": "go", "ʊ": "book",
    "u": "too", "ʌ": "cup", "ə": "about", "ɚ": "butter", "aɪ": "my",
    "aʊ": "now", "ɔɪ": "boy",
}

# per-language inventories, matching the released voices' phonemes.txt
# (markers _, #, |, ‖, stress and ² excluded)
INVENTORIES: typing.Dict[str, typing.Tuple[str, ...]] = {
    "de-de": (
        "a", "aɪ̯", "aʊ̯", "aː", "b", "d", "d͡ʒ", "eː", "f", "g", "h", "iː",
        "j", "k", "l", "m", "n", "oː", "p", "p͡f", "s", "t", "t͡s", "t͡ʃ",
        "uː", "v", "x", "yː", "z", "ãː", "ç", "õː", "øː", "ŋ", "œ", "ɐ",
        "ɔ", "ɔʏ̯", "ə", "ɛ", "ɛː", "ɛ̃ː", "ɪ", "ʁ", "ʃ", "ʊ", "ʏ", "ʒ",
        "ʔ", "χ",
    ),
    "en-us": (
        "aɪ", "aʊ", "b", "d", "d͡ʒ", "eɪ", "f", "h", "i", "j", "k", "l",
        "m", "n", "oʊ", "p", "s", "t", "t͡ʃ", "u", "v", "w", "z", "æ", "ð",
        "ŋ", "ɑ", "ɔ", "ɔɪ", "ə", "ɚ", "ɛ", "ɡ", "ɪ", "ɹ", "ʃ", "ʊ", "ʌ",
        "ʒ", "θ",
    ),
    "es-es": (
        "a", "ai", "au", "b", "d", "e", "ei", "eu", "f", "g", "i", "ja",
        "je", "jo", "ju", "k", "l", "m", "n", "o", "oi", "ou", "p", "r",
        "s", "t", "t͡ʃ", "u", "wa", "we", "wi", "wo", "x", "ɲ", "ɾ", "ʎ",
        "ʝ", "θ",
    ),
    "fr-fr": (
        "a", "b", "d", "e", "f", "i", "j", "k", "l", "m", "n", "o", "p",
        "s", "t", "u", "v", "w", "y", "z", "ø", "ŋ", "œ", "œ̃", "ɑ̃", "ɔ",
        "ɔ̃", "ə", "ɛ", "ɛ̃", "ɡ", "ɥ", "ɲ", "ʁ", "ʃ", "ʒ",
    ),
    "it-it": (
        "a", "b", "d", "d͡z", "d͡ʒ", "e", "f", "i", "j", "k", "l", "m",
        "n", "o", "p", "r", "s", "t", "t͡s", "t͡ʃ", "u", "v", "w", "z",
        "ŋ", "ɔ", "ɛ", "ɡ", "ɱ", "ɲ", "ʃ", "ʎ",
    ),
    "nl": (
        "a", "aː", "b", "c", "d", "e", "eː", "f", "h", "i", "iː", "j", "k",
        "l", "m", "n", "o", "oː", "p", "s", "t", "u", "uː", "v", "w", "x",
        "y", "yː", "z", "ø", "ŋ", "œy", "œː", "ɑ", "ɑu", "ɑː", "ɔ", "ɔː",
        "ə", "ɛ", "ɛi", "ɛː", "ɡ", "ɣ", "ɪ", "ɱ", "ɹ", "ʃ", "ʏ", "ʏː",
        "ʒ", "ʔ",
    ),
    "ru-ru": (
        "a", "aː", "b", "bʲ", "d", "dʲ", "e", "eː", "f", "fʲ", "i", "iː",
        "j", "k", "kʲ", "l", "lʲ", "m", "mʲ", "n", "nʲ", "o", "oː", "p",
        "pʲ", "r", "rʲ", "s", "sʲ", "t", "tʲ", "t͡s", "t͡ɕ", "u", "uː",
        "v", "vʲ", "x", "xʲ", "z", "zʲ", "ɕː", "ɡ", "ɡʲ", "ɨ", "ɨː", "ʂ",
        "ʐ",
    ),
    "sv-se": (
        "a", "b", "d", "eː", "f", "h", "iː", "j", "k", "l", "m", "n", "oː",
        "p", "r", "s", "t", "uː", "v", "yː", "øː", "ŋ", "œ", "ɑː", "ɔ",
        "ɕ", "ɛ", "ɛː", "ɡ", "ɧ", "ɪ", "ɵ", "ʉː", "ʊ", "ʏ",
    ),
    "sw": (
        "f", "h", "i", "j", "k", "l", "m", "n", "p", "s", "t", "t͡ʃ", "u",
        "v", "w", "x", "z", "ð", "ɑ", "ɓ", "ɗ", "ɔ", "ɛ", "ɠ", "ɣ", "ɾ",
        "ʃ", "θ", "ʄ", "ᵐɓ", "ᵑg", "ᶬv", "ⁿz", "ⁿɗ", "ⁿɗ͡ʒ",
    ),
}


@dataclasses.dataclass
class Phoneme:
    """Parsed IPA phoneme with articulatory features."""

    text: str
    kind: str  # "vowel" | "diphthong" | "consonant"
    # vowel/diphthong: list of (height, backness, rounded); an on-glide
    # (j/w/ɥ-initial sequence) contributes the glide's vowel target first
    vowel_parts: typing.List[typing.Tuple[str, str, bool]] = dataclasses.field(
        default_factory=list
    )
    # consonant features
    voiced: bool = True
    place: str = ""
    manner: str = ""
    # modifiers
    long: bool = False
    nasalized: bool = False
    palatalized: bool = False
    rhotic: bool = False
    prenasal: str = ""  # leading homorganic nasal ("m", "n", "ŋ", "ɱ")
    example: str = ""

    @property
    def stem(self) -> str:
        """Stable ascii file stem for the example WAV."""
        if self.kind == "consonant":
            voice = "voiced" if self.voiced else "voiceless"
            parts = [voice, self.place, self.manner]
        elif self.kind == "diphthong":
            names = [
                f"{h}_{b}_{'rounded' if r else 'unrounded'}"
                for h, b, r in self.vowel_parts
            ]
            parts = ["diphthong"] + ["_to_".join(names)]
        else:
            h, b, r = self.vowel_parts[0]
            parts = [h, b, "rounded" if r else "unrounded", "vowel"]
        if self.rhotic:
            parts.append("rhotic")
        if self.long:
            parts.append("long")
        if self.nasalized:
            parts.append("nasalized")
        if self.palatalized:
            parts.append("palatalized")
        if self.prenasal:
            parts.insert(0, "prenasalized")
        return "_".join(parts).replace("-", "")

    @property
    def description(self) -> str:
        return self.stem.replace("_", " ")


# the glide of an on-glide sequence maps to its vowel target
_GLIDE_VOWEL = {"j": ("close", "front", False), "w": ("close", "back", True),
                "ɥ": ("close", "front", True)}


def parse_phoneme(symbol: str) -> typing.Optional[Phoneme]:
    """Parse one IPA phoneme string into features; None if unrecognized."""
    text = symbol
    p = Phoneme(text=text, kind="consonant")
    # precomposed nasal vowels -> base + combining tilde (keep every other
    # codepoint as written; a full NFD pass would break ç and friends)
    s = "".join(
        unicodedata.normalize("NFD", ch)
        if unicodedata.decomposition(ch).endswith("0303")
        else ch
        for ch in symbol
    )

    if s and s[0] in _PRENASAL:
        p.prenasal = _PRENASAL[s[0]]
        s = s[1:]

    # strip suffix modifiers (may repeat / combine)
    mods = True
    while s and mods:
        if s.endswith(_LONG):
            p.long, s = True, s[: -len(_LONG)]
        elif s.endswith(_PALATALIZED):
            p.palatalized, s = True, s[: -len(_PALATALIZED)]
        elif s.endswith(_ASPIRATED) or s.endswith(_NON_SYLLABIC):
            s = s[:-1]
        elif s.endswith(_NASALIZED):
            p.nasalized, s = True, s[:-1]
        else:
            mods = False

    if not s:
        return None

    # interior combining marks (nasal vowels in diphthong position etc.)
    core = s.replace(_NON_SYLLABIC, "")
    if _NASALIZED in core:
        p.nasalized = True
        core = core.replace(_NASALIZED, "")

    if core in AFFRICATES or core.replace(_TIE, "") in AFFRICATES:
        key = core if core in AFFRICATES else core.replace(_TIE, "")
        p.voiced, p.place, p.manner = AFFRICATES[key]
        p.example = EXAMPLES_EN.get(text, "")
        return p

    if core in CONSONANTS:
        p.voiced, p.place, p.manner = CONSONANTS[core]
        p.example = EXAMPLES_EN.get(text, "")
        return p

    if core == "ɚ":
        p.kind = "vowel"
        p.rhotic = True
        p.vowel_parts = [VOWELS["ə"]]
        p.example = EXAMPLES_EN.get(text, "")
        return p

    # vowel / diphthong / on-glide sequence
    parts: typing.List[typing.Tuple[str, str, bool]] = []
    for idx, ch in enumerate(core):
        if ch in VOWELS:
            parts.append(VOWELS[ch])
        elif idx == 0 and ch in _GLIDE_VOWEL and len(core) > 1:
            parts.append(_GLIDE_VOWEL[ch])
        else:
            return None
    if not parts:
        return None
    p.kind = "vowel" if len(parts) == 1 else "diphthong"
    p.vowel_parts = parts
    p.example = EXAMPLES_EN.get(text, "")
    return p


def language_phonemes(lang: str) -> typing.Dict[str, Phoneme]:
    """{symbol: Phoneme} for a language's released-voice inventory."""
    out: typing.Dict[str, Phoneme] = {}
    for symbol in INVENTORIES.get(lang, ()):
        parsed = parse_phoneme(symbol)
        if parsed is not None:
            out[symbol] = parsed
    return out
