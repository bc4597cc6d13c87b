"""The ViT detector model."""
