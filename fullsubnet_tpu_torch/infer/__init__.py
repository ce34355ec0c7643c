"""Inference runtime: the ``full_band_crm_mask`` Inferencer and its CLI."""
