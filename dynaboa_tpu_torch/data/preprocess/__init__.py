"""Offline data preparation (reference utils/data_preprocess/*); the port
has the internet-video extraction."""
