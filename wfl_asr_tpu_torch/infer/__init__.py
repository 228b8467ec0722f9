from .pipeline import (InferenceSession, infer_audio, infer_folder,
                       infer_folder_batched)

__all__ = ["InferenceSession", "infer_audio", "infer_folder",
           "infer_folder_batched"]
