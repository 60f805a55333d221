"""The paper's tables on the port (the JAX package's top-level
``benchmarks/``): Table II per layer, Table IV model-wise, Fig. 3 and the
§IV-D1 partition application, each pricing the same measured work with
PM2Lat, NeuSight and the FLOPs/bytes proxy."""
