"""Command-line training apps."""
