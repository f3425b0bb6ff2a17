from .pairs import DenoiseDataset, list_pairs, load_image_f32, validation_denoise

__all__ = ["DenoiseDataset", "list_pairs", "load_image_f32", "validation_denoise"]
