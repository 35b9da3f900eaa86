# Dense decoder model of the port (models.transformer), its building
# blocks (models.common, models.attention) and the model API
# (models.model_zoo). The MoE, SSM, hybrid and enc-dec families come with
# later slices (ROADMAP.md, queue A12-A13).
