"""Backbones: the DINOv2 ViT with LoRA."""
