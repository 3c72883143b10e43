"""Backbones: the ViT core (DINOv2, EVA02, CLIP, SAM) with LoRA and Rein,
MiT and ResNetV1c."""
