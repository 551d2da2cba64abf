"""The txt2audio workload, a copy of ``chiaswarm_tpu/workloads/audio.py``:
AudioLDM-class audio (``txt2audio_callback``; the reference's
swarm/audio/audioldm.py: 20 steps and 10 s of 16 kHz audio by default) and
bark-class text to speech (``tts_callback``; swarm/audio/bark.py:11-38).

The artifact is MP3 (``audio/mpeg``) when an ``ffmpeg`` binary is on PATH,
encoded through its CLI as the reference's pydub does, else WAV
(``audio/wav``) through the standard library's ``wave``: content
negotiation, as in JAX, not a device fallback. The pipeline comes resident
from the registry on the slot's lead device (``pipelines/audio.py``); a
``seq`` > 1 slot raises (ROADMAP queue item 7). A TTS job's voice preset
comes as arrays (``parameters.history`` or ``parameters.voice_preset``:
{semantic_prompt, coarse_prompt, fine_prompt}); a preset named by a string
is refused with a ``ValueError`` (a fatal envelope), since the worker ships
no preset files.
"""

from __future__ import annotations

import functools
import io
import time
import wave
from typing import Any

import numpy as np

from chiaswarm_tpu_torch.node.output_processor import make_result


def pcm16_wav(samples: np.ndarray, sample_rate: int = 16000) -> bytes:
    """float [-1, 1] mono -> WAV bytes (16-bit PCM)."""
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wav:
        wav.setnchannels(1)
        wav.setsampwidth(2)
        wav.setframerate(sample_rate)
        wav.writeframes(pcm.tobytes())
    return buf.getvalue()


@functools.lru_cache(maxsize=1)
def _ffmpeg_path() -> str | None:
    import shutil

    return shutil.which("ffmpeg")


def mp3_bytes(samples: np.ndarray, sample_rate: int = 16000,
              bitrate: str = "128k") -> bytes | None:
    """float [-1, 1] mono -> MP3 bytes through the ffmpeg CLI, or None when
    there is no encoder."""
    exe = _ffmpeg_path()
    if exe is None:
        return None
    import subprocess

    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    try:
        proc = subprocess.run(
            [exe, "-hide_banner", "-loglevel", "error",
             "-f", "s16le", "-ar", str(sample_rate), "-ac", "1",
             "-i", "pipe:0", "-f", "mp3", "-b:a", bitrate, "pipe:1"],
            input=pcm, capture_output=True, timeout=120, check=True,
        )
    except Exception:
        return None
    return proc.stdout or None


def audio_artifact(samples: np.ndarray, sample_rate: int = 16000) -> dict:
    mp3 = mp3_bytes(samples, sample_rate)
    if mp3 is not None:
        return make_result(mp3, "audio/mpeg")
    return make_result(pcm16_wav(samples, sample_rate), "audio/wav")


def _finalize_audio(slot, t0: float, wav: np.ndarray, sr: int,
                    config: dict) -> tuple[dict, dict]:
    """Timing, the slot's descriptor and the audio artifact."""
    config.update({
        "nsfw": False,
        "generation_s": round(time.perf_counter() - t0, 3),
        "slot": slot.descriptor() if hasattr(slot, "descriptor") else str(slot),
    })
    return {"primary": audio_artifact(wav[0], sr)}, config


def txt2audio_callback(slot, model_name: str, *, seed: int,
                       registry=None,
                       prompt: str = "",
                       negative_prompt: str = "",
                       num_inference_steps: int = 20,
                       guidance_scale: float = 2.5,
                       audio_length_in_s: float = 10.0,
                       scheduler_type: str | None = None,
                       **_ignored: Any):
    """AudioLDM-class txt2audio: one waveform of ``audio_length_in_s``."""
    if registry is None:
        raise ValueError("txt2audio requires the model registry")
    pipe = registry.audio_pipeline(model_name,
                                   mesh=getattr(slot, "mesh", None))
    t0 = time.perf_counter()
    wav, sr, config = pipe(
        prompt=prompt or "",
        negative_prompt=negative_prompt or "",
        steps=int(num_inference_steps),
        guidance_scale=float(guidance_scale),
        duration_s=float(audio_length_in_s),
        seed=seed,
        scheduler=scheduler_type,
    )
    return _finalize_audio(slot, t0, wav, sr, config)


def tts_callback(slot, model_name: str, *, seed: int,
                 registry=None,
                 prompt: str = "",
                 audio_length_in_s: float = 4.0,
                 temperature: float = 0.7,
                 voice_preset_tokens: list[int] | None = None,
                 parameters: dict | None = None,
                 **_ignored: Any):
    """Bark-class TTS: three GPT stages and the codec decode
    (``pipelines/tts.py``), one waveform of ``audio_length_in_s``."""
    if registry is None:
        raise ValueError("tts requires the model registry")
    parameters = parameters or {}
    pipe = registry.tts_pipeline(model_name,
                                 mesh=getattr(slot, "mesh", None))
    t0 = time.perf_counter()
    history = parameters.get("history") or parameters.get("voice_preset")
    if isinstance(history, str):
        # upstream bark names presets ("v2/en_speaker_6") resolved from
        # bundled npz files this worker does not ship; a ValueError marks
        # the job fatal (swarm/generator.py:34-41 taxonomy)
        raise ValueError(
            f"named voice preset {history!r} is not available on this "
            "worker; send the preset arrays as parameters.history = "
            "{semantic_prompt, coarse_prompt, fine_prompt}")
    if history is not None:
        history = {k: np.asarray(v) for k, v in history.items()}
    wav, sr, config = pipe(
        prompt or "",
        duration_s=float(audio_length_in_s),
        seed=seed,
        temperature=float(temperature),
        voice_preset_tokens=(voice_preset_tokens
                             or parameters.get("voice_preset_tokens")),
        history=history,
    )
    return _finalize_audio(slot, t0, wav, sr, config)
