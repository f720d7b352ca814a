"""Content-specific feature extraction (counterpart of
`sonido_sonar_tpu/extractors/`): the schema, the single-program
extractor paths of the speech and music extractors, and the factory."""
