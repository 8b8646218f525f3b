"""Adam and its schedules, fault-tolerant checkpoints, and step builders."""
