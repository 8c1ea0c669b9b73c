"""Host-side helpers: conversions, image preprocessing, the NMF bases generator."""
