# Decoder models of the port (models.transformer: the dense, MoE, SSM and
# hybrid families), their building blocks (models.common,
# models.attention, models.moe, models.ssm) and the model API
# (models.model_zoo). The enc-dec and VLM families come with a later
# slice (ROADMAP.md, queue A13).
