from .audio import read_wav, write_wav, wav_duration, resample, peak_normalize

__all__ = ["read_wav", "write_wav", "wav_duration", "resample", "peak_normalize"]
