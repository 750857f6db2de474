"""Window constants and layout converters."""
