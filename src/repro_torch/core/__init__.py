# Execution scopes (core.scopes) and the device rule (core.device).
