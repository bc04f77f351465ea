from msa_tpu_torch.host.audio_io import load_wav, resample  # noqa: F401
from msa_tpu_torch.host.diarization import (  # noqa: F401
    Diarizer,
    EnergyVADDiarizer,
    FixedWindowDiarizer,
    make_diarizer,
)
from msa_tpu_torch.host.transcription import StubTranscriber, Transcriber, make_transcriber  # noqa: F401
from msa_tpu_torch.host.video import VideoReader, extract_audio_track  # noqa: F401
