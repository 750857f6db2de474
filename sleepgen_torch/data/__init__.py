"""Window constants, transforms, the window dataset and synthetic recordings."""
