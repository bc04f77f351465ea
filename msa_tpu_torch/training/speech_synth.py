"""Phonetic Portuguese speech synthesis (port of
``msa_tpu/training/speech_synth.py``): Portuguese words rendered as audio
whose phonetic content is recoverable, the spoken-word data of the ASR
recipe and of the synthetic meetings. numpy, byte-equal to JAX's from the
same generator.

The synthesis family of :func:`msa_tpu_torch.models.speaker.synth_voice`
(a glottal harmonic stack shaped by Lorentzian formant resonances, plus
noise), with TIME-VARYING per-phone targets:

- graphemes map to phones by deterministic Portuguese rules (digraphs
  nh/lh/ch/rr/ss/qu/gu, soft c/g before e,i, ç, x→ʃ, j→ʒ, silent h);
- vowels are formant targets (standard F1/F2/F3, scaled per speaker by a
  vocal-tract-length factor, so identity varies and phone class holds);
- stops are closure gaps and noise bursts at class-specific bands (labial
  low, velar mid, alveolar high), voiced stops keep a voice bar;
- fricatives are sustained band noise (s/z high, ʃ/ʒ mid, f/v flat);
- nasals and liquids are quieter voiced segments with their own formant
  targets; formant tracks interpolate linearly between phones
  (coarticulation ramps).

Prosody composes orthogonally:
:class:`msa_tpu_torch.training.train_audio_emotion.Prosody` sets the pitch
contour and level, rate, energy, tilt and attack, so the synthetic meetings
(:mod:`msa_tpu_torch.training.synth_av`) SPEAK emotion words with the
matching prosody.

The knot arrays (:func:`utterance_knots`, :func:`stack_knots`,
:func:`pack_knots`, :func:`unpack_knots`) are the host half of JAX's
batched device renderer ``render_knots_batch``, which feeds only the
whisper ASR trainer and has no counterpart in this module.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from msa_tpu_torch.models.speaker import VoiceSpec

SR = 16_000

# --- phone inventory ----------------------------------------------------------

# vowel formant targets (F1, F2, F3) in Hz — Brazilian Portuguese monophthongs
_VOWELS = {
    "a": (780.0, 1300.0, 2600.0),
    "e": (450.0, 1950.0, 2600.0),
    "E": (580.0, 1800.0, 2550.0),  # open e (é)
    "i": (300.0, 2250.0, 2900.0),
    "o": (450.0, 850.0, 2600.0),
    "O": (560.0, 950.0, 2550.0),  # open o (ó)
    "u": (330.0, 750.0, 2450.0),
}
# nasal vowels: same targets + a low nasal murmur resonance, slight damping
_NASAL_VOWELS = {"ã": "a", "õ": "o"}

# noise bands for frication/bursts: (low_hz, high_hz)
_BANDS = {
    "low": (400.0, 1600.0),  # labial bursts, rr frication
    "mid": (1800.0, 4200.0),  # ʃ/ʒ, velar bursts
    "high": (4000.0, 7600.0),  # s/z, alveolar bursts
    "flat": (800.0, 7000.0),  # f/v
}


@dataclasses.dataclass(frozen=True)
class Phone:
    kind: str  # vowel | stop | fric | nasal | liquid | tap | sil
    dur: float  # seconds (pre-prosody)
    formants: Tuple[float, float, float] = (500.0, 1500.0, 2500.0)
    voiced: bool = True
    band: str = "mid"  # noise band for stops/fricatives
    nasal: bool = False
    amp: float = 1.0


def _vowel(sym: str, stressed: bool = False, nasal: bool = False) -> Phone:
    return Phone(
        "vowel",
        0.14 if stressed else 0.10,
        _VOWELS[sym],
        nasal=nasal,
        amp=1.0,
    )


_CONSONANTS = {
    # stops: band = burst spectrum
    "p": Phone("stop", 0.075, voiced=False, band="low"),
    "b": Phone("stop", 0.070, voiced=True, band="low"),
    "t": Phone("stop", 0.075, voiced=False, band="high"),
    "d": Phone("stop", 0.070, voiced=True, band="high"),
    "k": Phone("stop", 0.080, voiced=False, band="mid"),
    "g": Phone("stop", 0.075, voiced=True, band="mid"),
    # fricatives
    "f": Phone("fric", 0.095, voiced=False, band="flat", amp=0.5),
    "v": Phone("fric", 0.085, voiced=True, band="flat", amp=0.5),
    "s": Phone("fric", 0.100, voiced=False, band="high", amp=0.7),
    "z": Phone("fric", 0.090, voiced=True, band="high", amp=0.6),
    "S": Phone("fric", 0.100, voiced=False, band="mid", amp=0.7),  # ʃ (x, ch)
    "Z": Phone("fric", 0.090, voiced=True, band="mid", amp=0.6),  # ʒ (j, soft g)
    # nasals
    "m": Phone("nasal", 0.075, (250.0, 1000.0, 2200.0), amp=0.55),
    "n": Phone("nasal", 0.075, (250.0, 1400.0, 2300.0), amp=0.55),
    "N": Phone("nasal", 0.080, (250.0, 2000.0, 2500.0), amp=0.55),  # ɲ (nh)
    # liquids
    "l": Phone("liquid", 0.060, (350.0, 1400.0, 2600.0), amp=0.7),
    "L": Phone("liquid", 0.065, (350.0, 2000.0, 2600.0), amp=0.7),  # ʎ (lh)
    "r": Phone("tap", 0.030, (400.0, 1500.0, 2500.0), amp=0.45),
    "R": Phone("fric", 0.090, voiced=True, band="low", amp=0.5),  # rr/initial r
}

_ACCENT_MAP = {
    "á": ("a", True), "â": ("a", True), "à": ("a", True),
    "é": ("E", True), "ê": ("e", True),
    "í": ("i", True), "ó": ("O", True), "ô": ("o", True),
    "ú": ("u", True), "ü": ("u", False),
}


def word_to_phones(word: str) -> List[Phone]:
    """Deterministic grapheme → phone mapping for one lowercase word."""
    w = word.lower()
    out: List[Phone] = []
    # mark the stressed vowel: explicit accent wins, else penultimate vowel
    accent_pos = [i for i, ch in enumerate(w) if ch in _ACCENT_MAP]
    vowel_pos = [
        i
        for i, ch in enumerate(w)
        if ch in "aeiouáâàéêíóôúü" or ch in _NASAL_VOWELS
    ]
    if accent_pos:
        stressed_at = accent_pos[0]
    elif len(vowel_pos) >= 2:
        stressed_at = vowel_pos[-2]
    elif vowel_pos:
        stressed_at = vowel_pos[0]
    else:
        stressed_at = -1

    i = 0
    while i < len(w):
        ch = w[i]
        nxt = w[i + 1] if i + 1 < len(w) else ""
        stressed = i == stressed_at
        # digraphs
        if ch == "n" and nxt == "h":
            out.append(_CONSONANTS["N"]); i += 2; continue
        if ch == "l" and nxt == "h":
            out.append(_CONSONANTS["L"]); i += 2; continue
        if ch == "c" and nxt == "h":
            out.append(_CONSONANTS["S"]); i += 2; continue
        if ch == "r" and nxt == "r":
            out.append(_CONSONANTS["R"]); i += 2; continue
        if ch == "s" and nxt == "s":
            out.append(_CONSONANTS["s"]); i += 2; continue
        if ch == "q":  # qu + e/i: u is silent; qu + a/o: k + u
            out.append(_CONSONANTS["k"])
            if nxt == "u" and i + 2 < len(w) and w[i + 2] in "ei":
                i += 2
            else:
                i += 1
            continue
        if ch == "g" and nxt == "u" and i + 2 < len(w) and w[i + 2] in "ei":
            out.append(_CONSONANTS["g"]); i += 2; continue
        # single graphemes
        if ch in _ACCENT_MAP:
            sym, _ = _ACCENT_MAP[ch]
            out.append(_vowel(sym, stressed=True)); i += 1; continue
        if ch in _NASAL_VOWELS:
            out.append(_vowel(_NASAL_VOWELS[ch], stressed, nasal=True))
            i += 1; continue
        if ch in _VOWELS:
            out.append(_vowel(ch, stressed)); i += 1; continue
        if ch == "c":
            out.append(_CONSONANTS["s" if nxt in "ei" else "k"]); i += 1; continue
        if ch == "ç":
            out.append(_CONSONANTS["s"]); i += 1; continue
        if ch == "g":
            out.append(_CONSONANTS["Z" if nxt in "ei" else "g"]); i += 1; continue
        if ch == "j":
            out.append(_CONSONANTS["Z"]); i += 1; continue
        if ch == "x":
            out.append(_CONSONANTS["S"]); i += 1; continue
        if ch == "r":
            out.append(_CONSONANTS["R" if i == 0 else "r"]); i += 1; continue
        if ch == "h":
            i += 1; continue  # silent
        if ch in _CONSONANTS:
            out.append(_CONSONANTS[ch]); i += 1; continue
        i += 1  # unknown symbol: skip
    return out


# --- track building -----------------------------------------------------------

_RAMP_S = 0.016  # coarticulation ramp between phones


def _phone_knots(
    rng: np.random.Generator,
    phones: Sequence[Phone],
    rate_scale: float,
):
    """Piecewise per-phone knot targets shared by the per-sample numpy path
    (:func:`_phone_tracks`) and the batched device renderer
    (:func:`utterance_knots`).

    Returns (times [k], knots [k, 8] with layout [F1, F2, F3, voice_amp,
    fric_amp, 3 spare], band_knots [k, 4], nasal_knots [k], total_dur_s)."""
    band_names = list(_BANDS)
    # knot times/values at each phone's center + hard edges for silence
    times: List[float] = [0.0]
    knots: List[np.ndarray] = []
    edge = np.zeros(8, np.float32)  # silence knot

    def knot(p: Phone) -> np.ndarray:
        # layout: [F1, F2, F3, voice_amp, fric_amp] (+3 spare slots)
        v = np.zeros(8, np.float32)
        v[0:3] = p.formants
        v[3] = p.amp if p.voiced else 0.0
        v[4] = p.amp if p.kind == "fric" else 0.0
        return v

    band_knots: List[np.ndarray] = []
    nas: List[float] = [0.0]
    t = 0.0
    knots.append(edge)
    band_knots.append(np.zeros(len(band_names), np.float32))
    for p in phones:
        dur = p.dur * rate_scale * float(rng.uniform(0.85, 1.15))
        nas_val = 0.6 if (p.nasal or p.kind == "nasal") else 0.0
        if p.kind == "sil":
            t += dur
            times.append(t)
            knots.append(edge)
            band_knots.append(np.zeros(len(band_names), np.float32))
            nas.append(0.0)
            continue
        # stops: closure (near-silence, voice bar if voiced) then burst
        if p.kind == "stop":
            t_clo = t + 0.6 * dur
            v_clo = np.zeros(8, np.float32)
            v_clo[0:3] = p.formants
            v_clo[3] = 0.18 if p.voiced else 0.0  # voice bar
            times.append(t_clo)
            knots.append(v_clo)
            band_knots.append(np.zeros(len(band_names), np.float32))
            nas.append(0.0)
            t_burst = t + 0.8 * dur
            v_b = np.zeros(8, np.float32)
            v_b[0:3] = p.formants
            v_b[3] = 0.2 if p.voiced else 0.0
            v_b[4] = 0.9
            bg = np.zeros(len(band_names), np.float32)
            bg[band_names.index(p.band)] = 1.0
            times.append(t_burst)
            knots.append(v_b)
            band_knots.append(bg)
            nas.append(0.0)
            t += dur
            continue
        center = t + 0.5 * dur
        v = knot(p)
        bg = np.zeros(len(band_names), np.float32)
        if p.kind == "fric":
            bg[band_names.index(p.band)] = 1.0
        times.append(center)
        knots.append(v)
        band_knots.append(bg)
        nas.append(nas_val)
        t += dur
    times.append(t + _RAMP_S)
    knots.append(edge)
    band_knots.append(np.zeros(len(band_names), np.float32))
    nas.append(0.0)
    return (
        np.asarray(times, np.float64),
        np.stack(knots),
        np.stack(band_knots),
        np.asarray(nas, np.float32),
        t,
    )


def _phone_tracks(
    rng: np.random.Generator,
    phones: Sequence[Phone],
    rate_scale: float,
    sample_rate: int,
):
    """Piecewise per-phone targets → per-sample tracks.

    Returns (formants [n,3], voice_amp [n], fric_amp [n], band_gain [n,4],
    nasal_amp [n]) — all linearly interpolated between phone centers so
    formant transitions carry coarticulation cues."""
    tk, K, BG, nas_knots, t = _phone_knots(rng, phones, rate_scale)

    n = max(1, int(round(t * sample_rate)))
    ts = np.arange(n) / sample_rate
    tracks = np.stack([np.interp(ts, tk, K[:, j]) for j in range(8)], axis=1)
    bands = np.stack(
        [np.interp(ts, tk, BG[:, j]) for j in range(BG.shape[1])], axis=1
    )
    formants = tracks[:, 0:3]
    voice_amp = tracks[:, 3]
    fric_amp = tracks[:, 4]
    nasal_amp = np.interp(ts, tk, nas_knots)
    return formants, voice_amp, fric_amp, bands, nasal_amp


def _noise_bands(rng: np.random.Generator, n: int, sample_rate: int) -> np.ndarray:
    """[n, 4] — one white-noise draw FFT-filtered into the fixed bands."""
    noise = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    out = np.empty((n, len(_BANDS)), np.float32)
    for j, (lo, hi) in enumerate(_BANDS.values()):
        mask = (freqs >= lo) & (freqs < hi)
        band = np.fft.irfft(spec * mask, n)
        out[:, j] = band / (np.std(band) + 1e-8)
    return out


def synth_utterance(
    rng: np.random.Generator,
    voice: VoiceSpec,
    text: str,
    sample_rate: int = SR,
    prosody=None,
    word_gap: float = 0.11,
) -> np.ndarray:
    """Render ``text`` (space-separated Portuguese words) as speech.

    ``voice`` supplies identity (f0 level, vocal-tract scale from its first
    formant, tilt, breathiness); ``prosody`` (optional
    :class:`msa_tpu_torch.training.train_audio_emotion.Prosody`) supplies the
    emotional modulation — pitch contour/level, rate, energy, tilt, attack.
    """
    phones: List[Phone] = []
    for w, word in enumerate(text.strip().split()):
        if w:
            phones.append(Phone("sil", word_gap, voiced=False))
        phones.extend(word_to_phones(word))
    if not phones:
        return np.zeros(int(0.2 * sample_rate), np.float32)

    f0_scale = 1.0
    f0_var = 0.04
    f0_slope = 0.0
    rate_scale = 1.0
    energy = 1.0
    tilt_mul = 1.0
    attack = 1.0
    if prosody is not None:
        f0_scale = prosody.f0_scale
        f0_var = max(prosody.f0_var, 0.02)
        f0_slope = prosody.f0_slope
        rate_scale = 3.5 / max(prosody.rate, 0.5)
        energy = prosody.energy
        tilt_mul = prosody.tilt
        attack = prosody.attack

    # speaker vocal-tract scale from the voice's (random) first formant
    vt_scale = float(np.clip(voice.formants[0] / 600.0, 0.82, 1.22))

    formants, voice_amp, fric_amp, bands, nasal_amp = _phone_tracks(
        rng, phones, rate_scale, sample_rate
    )
    formants = formants * vt_scale
    n = formants.shape[0]
    ts = np.arange(n) / sample_rate
    dur_s = n / sample_rate

    # pitch: level × slow modulation × contour slope × vibrato
    vibrato = 1.0 + 0.015 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * ts)
    wobble = 1.0 + f0_var * np.sin(
        2 * np.pi * rng.uniform(0.6, 1.4) * ts + rng.uniform(0, 2 * np.pi)
    )
    contour = 1.0 + f0_slope * (ts / max(dur_s, 1e-3) - 0.5)
    f0 = voice.f0 * f0_scale * vibrato * wobble * np.clip(contour, 0.5, 2.0)
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate

    tilt = float(np.clip(voice.tilt * tilt_mul, 0.4, 2.2))
    bw = voice.bandwidth
    f0_mean = float(np.mean(f0))
    n_harm = int(min(40, max(3, (sample_rate / 2 - 200) / f0_mean)))
    voiced = np.zeros(n, np.float32)
    for h in range(1, n_harm + 1):
        fh = h * f0  # [n]
        env = (
            1.0 / (1.0 + ((fh - formants[:, 0]) / bw) ** 2)
            + 1.0 / (1.0 + ((fh - formants[:, 1]) / bw) ** 2)
            + 0.5 / (1.0 + ((fh - formants[:, 2]) / (1.4 * bw)) ** 2)
            + nasal_amp * 0.8 / (1.0 + ((fh - 250.0) / 100.0) ** 2)
        )
        voiced += (env / h**tilt).astype(np.float32) * np.sin(
            h * phase + rng.uniform(0, 2 * np.pi)
        ).astype(np.float32)
    # sharper (attack>1) or softer syllable onsets
    vamp = np.power(np.clip(voice_amp, 0.0, None), attack)
    sig = voiced * vamp

    nb = _noise_bands(rng, n, sample_rate)
    sig = sig + 0.6 * fric_amp * np.sum(nb * bands, axis=1)
    sig = sig + voice.breathiness * rng.standard_normal(n).astype(np.float32) * (
        np.max(np.abs(sig)) + 1e-8
    )
    peak = np.max(np.abs(sig)) + 1e-8
    return (0.3 * energy * sig / peak).astype(np.float32)


# --- spoken sentences ----------------------------------------------------------

# sentence templates built ONLY from the ASR training vocabulary
# (train_whisper_asr.FILLERS + the emotion lexicon), so the shipped
# transcriber is maximally reliable on synth_av meeting speech
SPOKEN_TEMPLATES: Tuple[str, ...] = (
    "estou muito {w} hoje",
    "me sinto {w}",
    "que dia {w}",
    "ele foi tão {w}",
    "ela foi tão {w}",
    "isso foi {w}",
    "estou um pouco {w}",
    "hoje me sinto {w}",
)


def spoken_sentence(rng: np.random.Generator, word: str) -> str:
    """One template sentence around an emotion word."""
    return str(rng.choice(SPOKEN_TEMPLATES)).format(w=word)


# --- knot arrays: the host half of the batched renderer --------------------
#
# The host builds only the small per-phone KNOT arrays of a clip
# (`utterance_knots`); a batched renderer interpolates the per-sample tracks
# and renders the harmonic stack and noise bands with `synth_utterance`'s
# formulas.

#: knot-row budget for `utterance_knots` (longest 4-word sentence ≈ 70 rows)
KNOTS_MAX = 96
#: harmonic budget (matches `synth_utterance`'s n_harm cap)
HARMONICS = 40


def utterance_knots(
    rng: np.random.Generator,
    voice: VoiceSpec,
    text: str,
    window: int,
    sample_rate: int = SR,
    prosody=None,
    word_gap: float = 0.11,
    k_max: int = KNOTS_MAX,
) -> dict:
    """Host half of the device renderer: everything `synth_utterance` decides
    per clip (phones → knots, voice/prosody scalars, per-harmonic phases, a
    random window offset) packed as fixed-shape numpy arrays for ONE clip.

    Matches `make_clip`-style placement: the utterance starts at a uniform
    offset inside the static window and is truncated by the window end."""
    phones: List[Phone] = []
    for w, word in enumerate(text.strip().split()):
        if w:
            phones.append(Phone("sil", word_gap, voiced=False))
        phones.extend(word_to_phones(word))

    f0_scale, f0_var, f0_slope = 1.0, 0.04, 0.0
    rate_scale, energy, tilt_mul, attack = 1.0, 1.0, 1.0, 1.0
    if prosody is not None:
        f0_scale = prosody.f0_scale
        f0_var = max(prosody.f0_var, 0.02)
        f0_slope = prosody.f0_slope
        rate_scale = 3.5 / max(prosody.rate, 0.5)
        energy = prosody.energy
        tilt_mul = prosody.tilt
        attack = prosody.attack

    tk, K, BG, nas, dur_s = _phone_knots(rng, phones, rate_scale)
    vt_scale = float(np.clip(voice.formants[0] / 600.0, 0.82, 1.22))
    K = K.copy()
    K[:, 0:3] *= vt_scale

    # place the utterance at a random offset in the window (make_clip's
    # zero-padding + offset, host side of training/train_whisper_asr)
    free_s = max(0.0, window / sample_rate - dur_s)
    t_off = float(rng.uniform(0.0, free_s)) if free_s > 0 else 0.0

    k = tk.shape[0]
    assert k <= k_max, (k, k_max, text)
    times = np.full(k_max, tk[-1] + t_off, np.float32)
    times[:k] = tk + t_off
    knots = np.zeros((k_max, 8), np.float32)
    knots[:k] = K
    band_knots = np.zeros((k_max, BG.shape[1]), np.float32)
    band_knots[:k] = BG
    nas_knots = np.zeros(k_max, np.float32)
    nas_knots[:k] = nas

    f0_eff = voice.f0 * f0_scale
    n_harm = int(min(HARMONICS, max(3, (sample_rate / 2 - 200) / f0_eff)))
    harm_mask = (np.arange(HARMONICS) < n_harm).astype(np.float32)

    return {
        "knot_t": times,
        "knot_v": knots,
        "knot_bg": band_knots,
        "knot_nas": nas_knots,
        "f0": np.float32(f0_eff),
        "f0_var": np.float32(f0_var),
        "f0_slope": np.float32(f0_slope),
        "vib_freq": np.float32(rng.uniform(4.5, 6.5)),
        "wob_freq": np.float32(rng.uniform(0.6, 1.4)),
        "wob_phase": np.float32(rng.uniform(0, 2 * np.pi)),
        "t_off": np.float32(t_off),
        "dur": np.float32(max(dur_s, 1e-3)),
        "tilt": np.float32(np.clip(voice.tilt * tilt_mul, 0.4, 2.2)),
        "bw": np.float32(voice.bandwidth),
        "breath": np.float32(voice.breathiness),
        "attack": np.float32(attack),
        "energy": np.float32(energy),
        "harm_phase": rng.uniform(0, 2 * np.pi, HARMONICS).astype(np.float32),
        "harm_mask": harm_mask,
        "noise_floor": np.float32(rng.uniform(0.001, 0.004)),
    }


def stack_knots(clips: Sequence[dict]) -> dict:
    """[per-clip dict] → batched dict (leaf shapes [B, ...])."""
    return {k: np.stack([c[k] for c in clips]) for k in clips[0]}


#: scalar leaves of `utterance_knots`, in packed order
_SCALAR_KEYS = (
    "f0",
    "f0_var",
    "f0_slope",
    "vib_freq",
    "wob_freq",
    "wob_phase",
    "t_off",
    "dur",
    "tilt",
    "bw",
    "breath",
    "attack",
    "energy",
    "noise_floor",
)


def pack_knots(batch: dict) -> np.ndarray:
    """Batched knot dict (`stack_knots`) → ONE [B, D] f32 buffer: one
    transfer in place of twenty; :func:`unpack_knots` opens it."""
    b = batch["knot_t"].shape[0]
    parts = [
        np.asarray(batch["knot_t"], np.float32),
        np.asarray(batch["knot_v"], np.float32).reshape(b, -1),
        np.asarray(batch["knot_bg"], np.float32).reshape(b, -1),
        np.asarray(batch["knot_nas"], np.float32),
        np.asarray(batch["harm_phase"], np.float32),
        np.asarray(batch["harm_mask"], np.float32),
        np.stack([np.asarray(batch[k], np.float32) for k in _SCALAR_KEYS], axis=1),
    ]
    return np.concatenate(parts, axis=1)


def unpack_knots(flat) -> dict:
    """Inverse of :func:`pack_knots`, on numpy arrays or tensors (static
    slice bounds), restoring the batched knot dict."""
    k, h = KNOTS_MAX, HARMONICS
    bands = len(_BANDS)
    bounds = [k, 8 * k, bands * k, k, h, h, len(_SCALAR_KEYS)]
    offs = np.concatenate([[0], np.cumsum(bounds)])
    assert flat.shape[1] == offs[-1], (flat.shape, offs[-1])
    b = flat.shape[0]
    sl = [flat[:, offs[i] : offs[i + 1]] for i in range(len(bounds))]
    out = {
        "knot_t": sl[0],
        "knot_v": sl[1].reshape(b, k, 8),
        "knot_bg": sl[2].reshape(b, k, bands),
        "knot_nas": sl[3],
        "harm_phase": sl[4],
        "harm_mask": sl[5],
    }
    for j, name in enumerate(_SCALAR_KEYS):
        out[name] = sl[6][:, j]
    return out


def synth_spoken_clip(
    rng: np.random.Generator,
    voice: VoiceSpec,
    texts: Sequence[str],
    seconds: float,
    sample_rate: int = SR,
    prosody=None,
) -> np.ndarray:
    """Fill a fixed window with spoken sentences (cycled, separated by
    0.2–0.4 s pauses) — segment-shaped speech for synth_av meetings and the
    mixed-speech audio-emotion recipe."""
    n = int(seconds * sample_rate)
    out = np.zeros(n, np.float32)
    pos = int(rng.integers(0, int(0.15 * sample_rate) + 1))
    i = 0
    while pos < n - int(0.3 * sample_rate):
        text = texts[i % len(texts)]
        wav = synth_utterance(rng, voice, text, sample_rate, prosody=prosody)
        take = min(len(wav), n - pos)
        out[pos : pos + take] = wav[:take]
        pos += take + int(rng.uniform(0.2, 0.4) * sample_rate)
        i += 1
    return out
