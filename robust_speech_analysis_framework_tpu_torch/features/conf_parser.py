"""Parser for the openSMILE INI-style configuration dialect (subset).

The reference's only declarative configuration is ``Androids.conf`` (an
openSMILE component graph with its parameters). This module parses that
dialect — ``[instance:componentType]`` sections, ``key = value`` pairs, array
keys (``bands[0]``), ``;``/``//`` comments, ``\\cm[...]`` command
substitutions — and maps the parameters of the components the port
implements onto an :class:`~.opensmile.OpenSmileConfig`. Pure Python.
"""

from __future__ import annotations

import re
from typing import Dict

_SECTION_RE = re.compile(r"^\[(?P<name>[^:\]]+):(?P<type>[^\]]+)\]\s*$")
_CM_RE = re.compile(r"\\cm\[[^\]{]*(?:\{(?P<default>[^}]*)\})?[^\]]*\]")


def parse_conf(text: str) -> Dict[str, Dict[str, str]]:
    """Parse conf text → {"instance:componentType": {key: value}}.

    Values keep their raw string form; ``\\cm[...]`` substitutions resolve to
    their ``{default}`` (or the empty string). Comment styles: ``;``, ``//``,
    ``#`` and ``%`` at line start, ``;`` and ``//`` after whitespace.
    """
    sections: Dict[str, Dict[str, str]] = {}
    current = None
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith((";", "#", "%", "//")):
            continue
        m = _SECTION_RE.match(line)
        if m:
            current = f"{m.group('name').strip()}:{m.group('type').strip()}"
            sections.setdefault(current, {})
            continue
        if current is None or "=" not in line:
            continue
        key, _, value = line.partition("=")
        for marker in (" ;", " //", "\t;", "\t//"):  # trailing inline comments
            idx = value.find(marker)
            if idx >= 0:
                value = value[:idx]
        value = _CM_RE.sub(lambda m: m.group("default") or "", value)
        sections[current][key.strip()] = value.strip()
    return sections


def _get(sections, comp_type: str) -> Dict[str, str]:
    for name, params in sections.items():
        if name.endswith(":" + comp_type):
            return params
    return {}


def _f(params: Dict[str, str], key: str, default: float) -> float:
    try:
        return float(params.get(key, default))
    except ValueError:
        return default


def _i(params: Dict[str, str], key: str, default: int) -> int:
    try:
        return int(float(params.get(key, default)))
    except ValueError:
        return default


def opensmile_config_from_conf(text: str):
    """Build the port's OpenSmileConfig from an Androids.conf-style document.

    Reads cFramer frame geometry, cVectorPreemphasis k, cMelspec bands,
    cMfcc range, cPitchShs/cSpecScale/cPitchSmootherViterbi pitch
    parameters, the cValbasedSelector threshold and the cPitchJitter search
    range. Unknown components are ignored (the Androids DAG is fixed).
    """
    from ..audio.frontend import FrontendConfig
    from ..ops.shs_pitch import ShsParams
    from .opensmile import OpenSmileConfig

    s = parse_conf(text)
    framer = _get(s, "cFramer")
    pre = _get(s, "cVectorPreemphasis")
    mel = _get(s, "cMelspec")
    mfcc = _get(s, "cMfcc")
    shs = _get(s, "cPitchShs")
    scale = _get(s, "cSpecScale")
    viterbi = _get(s, "cPitchSmootherViterbi")
    gate = _get(s, "cValbasedSelector")
    jit = _get(s, "cPitchJitter")

    # cWaveSource.sampleRate is not honoured: openSMILE reads the rate from
    # the WAV header and uses that field only for headerless raw input. The
    # frame geometry is in seconds, so pinning the pipeline's 16 kHz keeps
    # frame sizes and the Hz-axis parameters right.
    frontend = FrontendConfig(
        sample_rate=16000,
        frame_seconds=_f(framer, "frameSize", 0.025),
        hop_seconds=_f(framer, "frameStep", 0.010),
        preemphasis=_f(pre, "k", 0.97),
        n_mels=_i(mel, "nBands", 26),
        fmin=_f(mel, "lofreq", 20.0),
        fmax=_f(mel, "hifreq", 8000.0),
    )
    first = _i(mfcc, "firstMfcc", 1)
    last = _i(mfcc, "lastMfcc", 12)
    shs_params = ShsParams(
        min_pitch=_f(shs, "minPitch", 52.0),
        max_pitch=_f(shs, "maxPitch", 620.0),
        n_candidates=_i(shs, "nCandidates", 6),
        n_harmonics=_i(shs, "nHarmonics", 15),
        compression=_f(shs, "compressionFactor", 0.85),
        voicing_cutoff=_f(shs, "voicingCutoff", 0.70),
        min_f_scale=_f(scale, "minF", 25.0),
        w_tvv=_f(viterbi, "wTvv", 10.0),
        w_tvvd=_f(viterbi, "wTvvd", 5.0),
        w_tvuv=_f(viterbi, "wTvuv", 10.0),
        w_thr=_f(viterbi, "wThr", 4.0),
        w_tuu=_f(viterbi, "wTuu", 0.0),
        w_local=_f(viterbi, "wLocal", 2.0),
        w_range=_f(viterbi, "wRange", 1.0),
    )
    return OpenSmileConfig(
        frontend=frontend,
        n_mfcc=last - first + 1,
        shs=shs_params,
        energy_gate=_f(gate, "threshold", 0.001),
        jitter_search_range=_f(jit, "searchRangeRel", 0.25),
    )
