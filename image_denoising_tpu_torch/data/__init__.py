from .pairs import (DenoiseDataset, DenoisePatchDataset, list_pairs, load_image_f32,
                    validation_denoise)

__all__ = ["DenoiseDataset", "DenoisePatchDataset", "list_pairs", "load_image_f32",
           "validation_denoise"]
