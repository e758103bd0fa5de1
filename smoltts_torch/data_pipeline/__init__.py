"""The offline data pipeline: audio -> Mimi codes (`encode_audio`), codes
and text -> packed ChatML training rows (`tokenize_dataset`, `prompt`),
model inits (`create_init`) and a listening tool (`preview`). The library
functions take rows (lists of dicts of numpy arrays); only the CLIs read HF
`datasets`, which they import inside `main`."""
