from repro_torch.data.synthetic import NYX_FIELDS, gaussian_random_field, nyx_like_field

__all__ = ["NYX_FIELDS", "gaussian_random_field", "nyx_like_field"]
