# Models of the port: the decoder-only families (models.transformer:
# dense, MoE, SSM, hybrid and VLM), the enc-dec family (models.encdec),
# their building blocks (models.common, models.attention, models.moe,
# models.ssm) and the model API (models.model_zoo).
