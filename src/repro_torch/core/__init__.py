"""The paper's contribution: collective algorithms, analytical models, tuning."""
