"""The paper's comparison baselines: the FLOPs/bytes proxy (``roofline``),
Habitat's wave scaling (``habitat``) and NeuSight's learned MLP
(``neusight``)."""
