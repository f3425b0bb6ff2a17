from .pairs import list_pairs, load_image_f32, validation_denoise

__all__ = ["list_pairs", "load_image_f32", "validation_denoise"]
