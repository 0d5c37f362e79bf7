"""The reference's examples, run by `python -m repro_torch.examples.<name>`:
`quickstart` (the paper's pipeline in the simulator), `din_serving` (DIN
trained briefly, then served) and `weather_graphcast` (GraphCast's
weather mode over an icosahedral multimesh)."""
