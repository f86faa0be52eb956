"""Unified CLI — the `tool.sh key=value` surface (SURVEY.md §1 L0).

The reference ships one shell launcher per tool mapping to a main class
(bbduk.sh -> bbduk.BBDukS, ...). Here one entry point dispatches by tool
name:  python -m bbtools_tpu <tool> key=value ...
Also usable per-tool: python -m bbtools_tpu.models.bbduk key=value ...
"""

from __future__ import annotations

import sys


def _bbduk(args):
    from .models.bbduk import main

    return main(args)


def _bbmap(args):
    from .models.bbmap import main

    return main(args)


def _remove_preset(args, what: str):
    """removehuman.sh / removemicrobes.sh / removecatdogmousehuman.sh:
    BBMap decontamination presets (minratio=0.9 maxindel=3 maxsites=1
    k=14 bloomfilter; mapped reads -> outm, clean reads -> outu). The
    reference hardcodes JGI-filesystem masked references; here ref= (or
    path= with a prebuilt index) must point at the local masked genome.
    """
    from .models.bbmap import main

    keys = {t.split("=")[0].lower() for t in args if "=" in t}
    if not ({"ref", "path", "indexpath"} & keys):
        raise ValueError(
            f"{what} requires ref= (masked {what} genome) or path= "
            "(prebuilt index); the reference's hardcoded JGI paths "
            "are not portable"
        )
    preset = [
        "minratio=0.9", "maxindel=3", "maxsites=1", "k=14",
        "bloomfilter=t",
    ]
    return main(preset + list(args))


def _bbwrap(args):
    """bbwrap.sh: map MULTIPLE in=/out= comma-lists against one reference
    without rebuilding the index (BBWrap.java role)."""
    from .core.parser import tokenize
    from .models.bbmap import BBMap, parse_args

    a = tokenize(args)
    ins = (a.get("in", "in1") or "").split(",")
    in2s = (a.get("in2") or "").split(",") if a.get("in2") else [None] * len(ins)
    outs = (a.get("out", "outm") or "").split(",") if a.get("out", "outm") else [None] * len(ins)
    base = [t for t in args if not t.split("=")[0] in ("in", "in1", "in2", "out", "outm")]
    tool = None
    for i, inp in enumerate(ins):
        sub = base + [f"in={inp}"]
        if i < len(in2s) and in2s[i]:
            sub.append(f"in2={in2s[i]}")
        if i < len(outs) and outs[i]:
            sub.append(f"out={outs[i]}")
        cfg = parse_args(sub)
        if tool is None:
            tool = BBMap(cfg)
        else:
            tool = BBMap(cfg, index=tool.index)  # reuse the index
        tool.run()
        tool.print_stats()
    return tool


def _mappacbio(args):
    from .models.bbmap import main

    return main(args, preset="pacbio")


def _bbmapskimmer(args):
    from .models.bbmap import main

    return main(args, preset="skimmer")


def _bbmerge(args):
    from .models.bbmerge import main

    return main(args)


def _tadpole(args):
    from .models.tadpole import main

    return main(args)


def _callvariants(args):
    from .models.callvariants import main

    return main(args)


def _kmercountexact(args):
    from .models.kmercountexact import main

    return main(args)


def _reformat(args):
    from .models.reformat import main

    return main(args)


def _stats(args):
    from .models.assemblystats import main

    return main(args)


def _randomreads(args):
    from .models.randomreads import main

    return main(args)


def _dedupe(args):
    from .models.dedupe import main

    return main(args)


def _bbnorm(args):
    from .models.bbnorm import main

    return main(args)


def _ecc(args):
    # ecc.sh = KmerNormalize with ecc=t keepall=t passes=1
    from .models.bbnorm import main

    return main(args, ecc_tool=True)


def _bbcms(args):
    from .models.bbcms import main

    return main(args)


def _loglog(args):
    from .models.loglog import main

    return main(args)


def _bbmask(args):
    from .models.bbmask import main

    return main(args)


def _seal(args):
    from .models.seal import main

    return main(args)


def _clumpify(args):
    from .models.clumpify import main

    return main(args)


def _bbsplitpairs(args):
    from .models.splitpairs import main

    return main(args)


def _sketch(args):
    from .models.sketch import main

    return main(args)


def _pileup(args):
    from .models.pileup import main

    return main(args)


def _gradesam(args):
    from .models.gradesam import main

    return main(args)


def _sortbyname(args):
    from .models.sortbyname import main

    return main(args)


def _calctruequality(args):
    from .models.calctruequality import main

    return main(args)


def _demux(args):
    from .models.demux import main

    return main(args)


def _consensus(args):
    from .models.consensus import main

    return main(args)


def _bbsplit(args):
    from .models.bbsplit import main

    return main(args)


def _lilypad(args):
    from .models.lilypad import main

    return main(args)


def _quickbin(args):
    from .models.quickbin import main

    return main(args)


def _quickclade(args):
    from .models.clade import main

    return main(args)


def _callgenes(args):
    from .models.callgenes import main

    return main(args)


def _crosscontaminate(args):
    from .models.contam import cross_contaminate

    return cross_contaminate(args)


def _makecontaminated(args):
    from .models.contam import make_contaminated

    return make_contaminated(args)


def _gradevcf(args):
    from .utils.graders2 import grade_vcf_main

    return grade_vcf_main(args)


def _grademerged(args):
    from .utils.graders2 import grade_merged_main

    return grade_merged_main(args)


def _shred(args):
    from .models.smalltools import shred

    return shred(args)


def _fuse(args):
    from .models.smalltools import fuse

    return fuse(args)


def _partition(args):
    from .models.smalltools import partition

    return partition(args)


def _countunique(args):
    from .models.smalltools import count_uniqueness

    return count_uniqueness(args)


def _icecream(args):
    from .models.icecream import main

    return main(args)


def _server(args):
    from .models.server import main

    return main(args)


def _filterbytile(args):
    from .models.filterbytile import main

    return main(args)


def _taxonomy(args):
    from .models.taxonomy import main

    return main(args)


def _filterbytaxa(args):
    from .models.taxonomy import filter_by_taxa

    return filter_by_taxa(args)


TOOLS = {
    "bbduk": _bbduk,
    "bbmap": _bbmap,
    "bbwrap": _bbwrap,
    "bbmapskimmer": _bbmapskimmer,
    "mappacbio": _mappacbio,
    "mappacbioskimmer": _bbmapskimmer,
    "comparesketch": _sketch,
    "bbmerge": _bbmerge,
    "tadpole": _tadpole,
    "callvariants": _callvariants,
    "kmercountexact": _kmercountexact,
    "kmercount": _kmercountexact,
    "reformat": _reformat,
    "stats": _stats,
    "assemblystats": _stats,
    "randomreads": _randomreads,
    "dedupe": _dedupe,
    "bbnorm": _bbnorm,
    "ecc": _ecc,
    "bbcms": _bbcms,
    "loglog": _loglog,
    "bbmask": _bbmask,
    "seal": _seal,
    "clumpify": _clumpify,
    "bbsplitpairs": _bbsplitpairs,
    "splitpairs": _bbsplitpairs,
    "sendsketch": _sketch,
    "sketch": _sketch,
    "pileup": _pileup,
    "coveragepileup": _pileup,
    "gradesam": _gradesam,
    "sortbyname": _sortbyname,
    "bbsort": _sortbyname,
    "calctruequality": _calctruequality,
    "demuxbyname": _demux,
    "demux": _demux,
    "consensus": _consensus,
    "consensusmaker": _consensus,
    "bbsplit": _bbsplit,
    "filterbytile": _filterbytile,
    "lilypad": _lilypad,
    "quickbin": _quickbin,
    "quickclade": _quickclade,
    "clade": _quickclade,
    "callgenes": _callgenes,
    "crosscontaminate": _crosscontaminate,
    "makecontaminatedgenomes": _makecontaminated,
    "gradevcf": _gradevcf,
    "comparevcf": _gradevcf,
    "grademerged": _grademerged,
    "grademergedreads": _grademerged,
    "shred": _shred,
    "fuse": _fuse,
    "fusesequence": _fuse,
    "partition": _partition,
    "partitionreads": _partition,
    "bbcountunique": _countunique,
    "calcuniqueness": _countunique,
    "icecream": _icecream,
    "icecreamfinder": _icecream,
    "taxserver": _server,
    "sketchserver": _server,
    "server": _server,
    "analyzeflowcell": _filterbytile,
    "taxonomy": _taxonomy,
    "taxtree": _taxonomy,
    "filterbytaxa": _filterbytaxa,
    "novademux": lambda a: _lazy("novademux", "main", a),
    "indelfree": lambda a: _lazy("indelfree", "main", a),
    "msa": lambda a: _lazy("findprimers", "main", a),
    "rqcfilter": lambda a: _lazy("rqcfilter", "main", a),
    "rqcfilter2": lambda a: _lazy("rqcfilter", "main", a),
    "decontaminate": lambda a: _lazy("decontaminate", "main", a),
    "crossblock": lambda a: _lazy("decontaminate", "main", a),
    "summarizecrossblock": lambda a: _lazy(
        "decontaminate", "summarizecrossblock", a
    ),
    "trimcontigs": lambda a: _lazy("seqtools", "trimcontigs", a),
    "dedupebymapping": lambda a: _lazy("samutils", "dedupebymapping", a),
    "invertvcf": lambda a: _lazy("vcftools", "invertvcf", a),
    "fastqscan": lambda a: _lazy("texttools", "fastqscan", a),
    "grademerge": _grademerged,
    "khist": lambda a: _lazy("kmercountexact", "main", a),
    "taxsize": lambda a: _lazy("taxonomy", "taxsize", a),
    "explodetree": lambda a: _lazy("taxonomy", "explodetree", a),
    "shrinkaccession": lambda a: _lazy("taxonomy", "shrinkaccession", a),
    "gi2ancestors": lambda a: _lazy("taxonomy", "gi2ancestors", a),
    # same-class v2/auto launcher rows (the reference ships these as
    # separate .sh files over successor classes of the same tools)
    "mergesam2": lambda a: _lazy("samutils", "mergesam", a),
    "shuffle2": lambda a: _lazy("seqtools", "shuffle", a),
    "kmerlimit2": lambda a: _lazy("synthtools", "kmerlimit", a),
    "sketchblacklist2": lambda a: _lazy("texttools", "sketchblacklist", a),
    "rqcfilter3": lambda a: _lazy("rqcfilter", "main", a),
    "callvariants2": lambda a: _lazy("callvariants", "main", a),
    "bbmerge-auto": lambda a: _lazy("bbmerge", "main", a),
    "bbsketch": _sketch,
    "sendclade": _quickclade,
    "keepbestcopy": lambda a: _lazy("ribo", "mergeribo", a),
    "loadreads": lambda a: _lazy("texttools", "fastqscan", a),
    "summarizemerge": lambda a: _lazy("texttools", "summarizemerge", a),
    "summarizequast": lambda a: _lazy("texttools", "summarizequast", a),
    "invertkey": lambda a: _lazy("texttools", "invertkey", a),
    "bamlinestreamer": lambda a: _lazy("texttools", "bam2sam", a),
    "streamsam": lambda a: _lazy("texttools", "bam2sam", a),
    "bam2sam": lambda a: _lazy("texttools", "bam2sam", a),
    "gitable": lambda a: _lazy("taxonomy", "gitable", a),
    "bbversion": lambda a: print("bbtools_tpu 2.0 (BBTools 39.x surface)"),
    "removehuman": lambda a: _remove_preset(a, "human"),
    "removehuman2": lambda a: _remove_preset(a, "human"),
    "removemicrobes": lambda a: _remove_preset(a, "microbe"),
    "removecatdogmousehuman": lambda a: _remove_preset(a, "catdogmousehuman"),
    "reformatpb": lambda a: _lazy("icecream", "reformatpb", a),
    "tadpipe": lambda a: _lazy("tadpipe", "tadpipe", a),
    "tadwrapper": lambda a: _lazy("tadpipe", "tadpolewrapper", a),
    "tadpolewrapper": lambda a: _lazy("tadpipe", "tadpolewrapper", a),
    "comparelabels": lambda a: _lazy("barcodetools", "comparelabels", a),
    "consect": lambda a: _lazy("misctools", "consect", a),
    "mergeotus": lambda a: _lazy("misctools", "mergeotus", a),
    "plotgc": lambda a: _lazy("texttools", "plotgc", a),
    "bbest": lambda a: _lazy("samutils", "samtoest", a),
    "samtoest": lambda a: _lazy("samutils", "samtoest", a),
    "filterassemblysummary": lambda a: _lazy(
        "taxonomy", "filterassemblysummary", a
    ),
    "analyzeaccession": lambda a: _lazy("taxonomy", "analyzeaccession", a),
    "fetchproks": lambda a: _lazy("taxonomy", "fetchproks", a),
    "splitribo": lambda a: _lazy("ribo", "splitribo", a),
    "mergeribo": lambda a: _lazy("ribo", "mergeribo", a),
    "randomreadsmg": lambda a: _lazy("synthtools", "randomreadsmg", a),
    "kmerfilterset": lambda a: _lazy("synthtools", "kmerfilterset", a),
    "icecreammaker": lambda a: _lazy("synthtools", "icecreammaker", a),
    "icecreamgrader": lambda a: _lazy("synthtools", "icecreamgrader", a),
    "gbff2gff": lambda a: _lazy("gfftools", "gbff2gff", a),
    "mergesketch": lambda a: _lazy("sketch", "mergesketch", a),
    "subsketch": lambda a: _lazy("sketch", "subsketch", a),
    "summarizesketch": lambda a: _lazy("sketch", "summarizesketch", a),
    "readlength": lambda a: _lazy("texttools", "readlength", a),
    "countgc": lambda a: _lazy("texttools", "countgc", a),
    "testformat": lambda a: _lazy("texttools", "testformat", a),
    "translate6frames": lambda a: _lazy("texttools", "translate6frames", a),
    "statswrapper": lambda a: _lazy("texttools", "statswrapper", a),
    "sketchblacklist": lambda a: _lazy("texttools", "sketchblacklist", a),
    "bloomfilter": lambda a: _lazy("texttools", "bloomfilter", a),
    "rename": lambda a: _lazy("texttools", "rename", a),
    "bbrename": lambda a: _lazy("texttools", "rename", a),
    "kmercountmulti": lambda a: _lazy("texttools", "kmercountmulti", a),
    "findprimers": lambda a: _lazy("findprimers", "main", a),
    "indelfreealigner": lambda a: _lazy("indelfree", "main", a),
    "filterbyname": lambda a: _lazy("filtertools", "filterbyname", a),
    "filterbysequence": lambda a: _lazy("filtertools", "filterbysequence", a),
    "filtersam": lambda a: _lazy("filtertools", "filtersam", a),
    "countbarcodes": lambda a: _lazy("filtertools", "countbarcodes", a),
    "countbarcodes2": lambda a: _lazy("filtertools", "countbarcodes", a),
    "cutprimers": lambda a: _lazy("filtertools", "cutprimers", a),
    "mutate": lambda a: _lazy("synthtools", "mutate", a),
    "mutategenome": lambda a: _lazy("synthtools", "mutate", a),
    "bbfakereads": lambda a: _lazy("synthtools", "fakereads", a),
    "fakereads": lambda a: _lazy("synthtools", "fakereads", a),
    "kcompress": lambda a: _lazy("synthtools", "kcompress", a),
    "kmerlimit": lambda a: _lazy("synthtools", "kmerlimit", a),
    "findrepeats": lambda a: _lazy("synthtools", "findrepeats", a),
    "addadapters": lambda a: _lazy("synthtools", "addadapters", a),
    "makechimeras": lambda a: _lazy("synthtools", "makechimeras", a),
    "checkstrand": lambda a: _lazy("synthtools", "checkstrand", a),
    "splitsam": lambda a: _lazy("samutils", "splitsam", a),
    "splitsam4way": lambda a: _splitsam_n(a, 4),
    "splitsam6way": lambda a: _splitsam_n(a, 6),
    "mergesam": lambda a: _lazy("samutils", "mergesam", a),
    "samtoroc": lambda a: _lazy("samutils", "samtoroc", a),
    "filtervcf": lambda a: _lazy("vcftools", "filtervcf", a),
    "applyvariants": lambda a: _lazy("vcftools", "applyvariants", a),
    "vcf2gff": lambda a: _lazy("vcftools", "vcf2gff", a),
    "shuffle": lambda a: _lazy("seqtools", "shuffle", a),
    "getreads": lambda a: _lazy("seqtools", "getreads", a),
    "replaceheaders": lambda a: _lazy("seqtools", "replaceheaders", a),
    "filterbycoverage": lambda a: _lazy("seqtools", "filterbycoverage", a),
    "randomgenome": lambda a: _lazy("seqtools", "randomgenome", a),
    "makepolymers": lambda a: _lazy("seqtools", "makepolymers", a),
    "tetramerfreq": lambda a: _lazy("seqtools", "tetramerfreq", a),
    "callpeaks": lambda a: _lazy("seqtools", "callpeaks", a),
    "polyfilter": lambda a: _lazy("polyfilter", "main", a),
    "repair": lambda a: _lazy("splitpairs", "main", list(a) + ["repair=t"]),
    "mergesorted": lambda a: _lazy("sortbyname", "mergesorted", a),
    "filterlines": lambda a: _lazy("texttools", "filterlines", a),
    "countsharedlines": lambda a: _lazy("texttools", "countsharedlines", a),
    "unicode2ascii": lambda a: _lazy("texttools", "unicode2ascii", a),
    "phylip2fasta": lambda a: _lazy("texttools", "phylip2fasta", a),
    "summarizeseal": lambda a: _lazy("texttools", "summarizeseal", a),
    "splitnextera": lambda a: _lazy("splitnextera", "main", a),
    "fixgaps": lambda a: _lazy("fixgaps", "main", a),
    "countduplicates": lambda a: _lazy("misctools", "countduplicates", a),
    "commonkmers": lambda a: _lazy("misctools", "commonkmers", a),
    "kmerposition": lambda a: _lazy("misctools", "kmerposition", a),
    "mergebarcodes": lambda a: _lazy("misctools", "mergebarcodes", a),
    "removesmartbell": lambda a: _lazy("misctools", "removesmartbell", a),
    "mergefastacontigs": lambda a: _lazy(
        "misctools", "mergefastacontigs", a),
    "partitionfastafile": lambda a: _lazy(
        "misctools", "partitionfastafile", a),
    "filtersubs": lambda a: _lazy("misctools", "filtersubs", a),
    "kmercoverage": lambda a: _lazy("misctools", "kmercoverage", a),
    "bbrealign": lambda a: _lazy("bbrealign", "main", a),
    "fungalrelease": lambda a: _lazy("fungalrelease", "main", a),
    "gradebins": lambda a: _lazy("gradebins", "main", a),
    "muxbyname": lambda a: _lazy("barcodetools", "muxbyname", a),
    "removebadbarcodes": lambda a: _lazy("barcodetools", "removebadbarcodes", a),
    "filterbarcodes": lambda a: _lazy("barcodetools", "filterbarcodes", a),
    "cutgff": lambda a: _lazy("gfftools", "cutgff", a),
    "comparegff": lambda a: _lazy("gfftools", "comparegff", a),
    "alltoall": lambda a: _lazy("alltoall", "main", a),
    "idmatrix": lambda a: _lazy("alltoall", "main", a),
    "kmutate": lambda a: _lazy("synthtools", "kmutate", a),
    "picksubset": lambda a: _lazy("texttools", "picksubset", a),
    "summarizecoverage": lambda a: _lazy("texttools", "summarizecoverage", a),
    "summarizescafstats": lambda a: _lazy("texttools", "summarizescafstats", a),
    "splitbytaxa": lambda a: _lazy("taxonomy", "split_by_taxa", a),
    "fusebytaxa": lambda a: _lazy("taxonomy", "fuse_by_taxa", a),
    "gi2taxid": lambda a: _lazy("taxonomy", "gi2taxid", a),
    "splitnexteralmp": lambda a: _lazy("splitnextera", "main", a),
    # in-reference rewrites of the same tool surface (reformat2/3 ->
    # ReformatReads2/3, pileup2 -> CoveragePileup2, stats3, dedupe2,
    # testformat2): one implementation here serves all generations
    "reformat2": _reformat,
    "reformat3": _reformat,
    "pileup2": _pileup,
    "stats3": _stats,
    "bbstats": _stats,
    "dedupe2": _dedupe,
    "testformat2": lambda a: _lazy("texttools", "testformat", a),
    # idaligner/aligner launcher family (idaligner/Test.java testAndPrint
    # surface; per-engine launchers <engine>aligner.sh). Research "plus"
    # variants map to their family's engine (documented refinement in
    # ops/idalign.make_id_aligner).
    "glocalaligner": lambda a: _lazy("alignertools", "test_main", a, "glocal"),
    "bandedaligner": lambda a: _lazy("alignertools", "test_main", a, "banded"),
    "bandedplusaligner": lambda a: _lazy(
        "alignertools", "test_main", a, "bandedplus"),
    "driftingaligner": lambda a: _lazy(
        "alignertools", "test_main", a, "drifting"),
    "driftingplusaligner": lambda a: _lazy(
        "alignertools", "test_main", a, "driftingplus"),
    "wavefrontaligner": lambda a: _lazy(
        "alignertools", "test_main", a, "wavefront"),
    "quantumaligner": lambda a: _lazy(
        "alignertools", "test_main", a, "quantum"),
    "quabblealigner": lambda a: _lazy(
        "alignertools", "test_main", a, "quabble"),
    "scrabblealigner": lambda a: _lazy(
        "alignertools", "test_main", a, "scrabble"),
    "wobblealigner": lambda a: _lazy("alignertools", "test_main", a, "wobble"),
    "wobbleplusaligner": lambda a: _lazy(
        "alignertools", "test_main", a, "wobbleplus"),
    "crosscutaligner": lambda a: _lazy(
        "alignertools", "test_main", a, "crosscut"),
    "xdrophaligner": lambda a: _lazy("alignertools", "test_main", a, "xdroph"),
    "parallelogram": lambda a: _lazy(
        "alignertools", "test_main", a, "parallelogram"),
    "smithwaterman": lambda a: _lazy("alignertools", "test_main", a, "glocal"),
    "testaligners": lambda a: _lazy("alignertools", "test_main", a),
    "testaligners2": lambda a: _lazy("alignertools", "suite_main", a),
    "testalignersbatch": lambda a: _lazy("alignertools", "batch_main", a),
    "testalignerslength": lambda a: _lazy("alignertools", "length_main", a),
    "alignrandom": lambda a: _lazy("alignertools", "align_random_main", a),
    "alignerbenchmark": lambda a: _lazy("alignertools", "benchmark_main", a),
    "visualizealignment": lambda a: _lazy("alignertools", "visualize_main", a),
    "wavefrontalignerviz": lambda a: _lazy(
        "alignertools", "visualize_main", a),
    "microalign": lambda a: _lazy("alignertools", "micro_main", a),
    # same-main-class launcher aliases: bbdukS.sh is the current bbduk.sh
    # main (bbduk.BBDukS), bbdukOld.sh the legacy jgi.BBDuk monolith;
    # bbmap5/bbmapacc are align2.BBMap5/BBMapAcc generations of the same
    # pipeline; mapPacBio.sh is the camel-case launcher for mappacbio.
    "bbduks": _bbduk,
    "bbdukold": _bbduk,
    "bbmap5": _bbmap,
    "bbmapacc": _bbmap,
    # ml/ tool family over the CellNet runtime
    "seqtovec": lambda a: _lazy("mltools", "seqtovec_main", a),
    "train": lambda a: _lazy("mltools", "train_main", a),
    "netconvert": lambda a: _lazy("mltools", "netconvert_main", a),
    "scoresequence": lambda a: _lazy("mltools", "scoresequence_main", a),
    "netfilter": lambda a: _lazy("mltools", "netfilter_main", a),
    "reducecolumns": lambda a: _lazy("mltools", "reducecolumns_main", a),
    "vectorutils": lambda a: _lazy("mltools", "vectorutils_main", a),
    "balancevectors": lambda a: _lazy("mltools", "balancevectors_main", a),
    # SSU/Silva ribosomal family
    "comparessu": lambda a: _lazy("ssutools", "comparessu_main", a),
    "findssu": lambda a: _lazy("ssutools", "findssu_main", a),
    "filtersilva": lambda a: _lazy("ssutools", "filtersilva_main", a),
    "reducesilva": lambda a: _lazy("ssutools", "reducesilva_main", a),
    "addssu": lambda a: _lazy("ssutools", "addssu_main", a),
    "idtree": lambda a: _lazy("ssutools", "idtree_main", a),
    "trnaconsensus": lambda a: _lazy("ssutools", "trnaconsensus_main", a),
    "runhmm": lambda a: _lazy("ssutools", "runhmm_main", a),
    # servers: one ThreadingHTTPServer serves tax/sketch/clade/demux
    # endpoints (the reference runs one process per service)
    "demuxserver": _server,
    "cladeserver": _server,
    "ssuserver": _server,
    "cladeloader": lambda a: _lazy("clade", "cladeloader_main", a),
    # file/stream utilities
    "unzip": lambda a: _lazy("fileutils", "unzip_main", a),
    "cat": lambda a: _lazy("fileutils", "cat_main", a),
    "copyfile": lambda a: _lazy("fileutils", "copyfile_main", a),
    "textfile": lambda a: _lazy("fileutils", "textfile_main", a),
    "filescan": lambda a: _lazy("fileutils", "filescan_main", a),
    "printtime": lambda a: _lazy("fileutils", "printtime_main", a),
    "stream": lambda a: _lazy("fileutils", "streamer_main", a),
    "samstreamer": lambda a: _lazy("fileutils", "samstreamer_main", a),
    "diskbench": lambda a: _lazy("fileutils", "diskbench_main", a),
    "testfilesystem": lambda a: _lazy("fileutils", "testfilesystem_main", a),
    "a_sample_mt": lambda a: _lazy("fileutils", "sample_mt_main", a),
    # misc sequence/SAM/interval tools
    "adjusthomopolymers": lambda a: _lazy(
        "seqmisc", "adjusthomopolymers_main", a),
    "restorebases": lambda a: _lazy("seqmisc", "restorebases_main", a),
    "representative": lambda a: _lazy("seqmisc", "representative_main", a),
    "bedset": lambda a: _lazy("seqmisc", "bedset_main", a),
    "tagandmerge": lambda a: _lazy("seqmisc", "tagandmerge_main", a),
    "processhi-c": lambda a: _lazy("seqmisc", "hic_junctions_main", a),
    "synthmda": lambda a: _lazy("seqmisc", "synthmda_main", a),
    "kmercountshort": lambda a: _lazy("seqmisc", "kmercountshort_main", a),
    "kmerhashdump": lambda a: _lazy("seqmisc", "kmerhashdump_main", a),
    "estherfilter": lambda a: _lazy("seqmisc", "estherfilter_main", a),
    "renameref": lambda a: _lazy("seqmisc", "renameref_main", a),
    "renamebymapping": lambda a: _lazy("seqmisc", "renamebymapping_main", a),
    "renamecami": lambda a: _lazy("seqmisc", "renamecami_main", a),
    "renameimg": lambda a: _lazy("seqmisc", "renameimg_main", a),
    "renamebysketch": lambda a: _lazy("seqmisc", "renamebysketch_main", a),
    # hiseq flowcell plumbing
    "tiledump": lambda a: _lazy("hiseqtools", "tiledump_main", a),
    "plotflowcell": lambda a: _lazy("hiseqtools", "plotflowcell_main", a),
    "plothist": lambda a: _lazy("hiseqtools", "plothist_main", a),
    "plotreadposition": lambda a: _lazy(
        "hiseqtools", "plotreadposition_main", a),
    "cg2illumina": lambda a: _lazy("hiseqtools", "cg2illumina_main", a),
    "kapastats": lambda a: _lazy("hiseqtools", "kapastats_main", a),
    # PGM gene-model training/merging
    "analyzegenes": lambda a: _lazy("pgmtrain", "analyzegenes_main", a),
    "mergepgm": lambda a: _lazy("pgmtrain", "mergepgm_main", a),
    # protein family
    "proteinsearch": lambda a: _lazy("prottools", "proteinsearch_main", a),
    "clusterproteins": lambda a: _lazy(
        "prottools", "clusterproteins_main", a),
    "markerfactory": lambda a: _lazy("prottools", "markerfactory_main", a),
    "markervector": lambda a: _lazy("prottools", "markervector_main", a),
    "magqc": lambda a: _lazy("prottools", "magqc_main", a),
    # compositional scalars
    "scalars": lambda a: _lazy("scalartools", "scalars_main", a),
    "scalarintervals": lambda a: _lazy(
        "scalartools", "scalarintervals_main", a),
    "cloudplot": lambda a: _lazy("scalartools", "cloudplot_main", a),
    # cardinality estimator harnesses (one accuracy sweep serves the
    # FLL2/TTLL/DLC/LCHist/MantissaCompare/LowComplex research family)
    "fll2simulate": lambda a: _lazy(
        "research", "cardinality_sim_main", a, "fll2"),
    "ttllsimulate": lambda a: _lazy(
        "research", "cardinality_sim_main", a, "ttll"),
    "dlctieraccuracy": lambda a: _lazy(
        "research", "cardinality_sim_main", a, "dlctier"),
    "trainlchist": lambda a: _lazy(
        "research", "cardinality_sim_main", a, "lchist"),
    "mantissacompare": lambda a: _lazy(
        "research", "cardinality_sim_main", a, "mantissa"),
    "lowcomplexcalibrate": lambda a: _lazy(
        "research", "cardinality_sim_main", a, "lowcomplex"),
    # ddl sketch pipeline (exact bottom-k engine serves the DDL contract)
    "ddlwriter": lambda a: _lazy("research", "ddlwriter_main", a),
    "ddlmerger": lambda a: _lazy("research", "ddlmerger_main", a),
    "ddlcompare": lambda a: _lazy("research", "ddlcompare_main", a),
    "ddlblacklist": lambda a: _lazy("research", "ddlblacklist_main", a),
    "ddlcalibrate": lambda a: _lazy("research", "ddlcalibrate_main", a),
    # ml extras
    "calibrate": lambda a: _lazy("research", "calibrate_main", a),
    "regressiontrainer": lambda a: _lazy(
        "research", "regressiontrainer_main", a),
    "rankingvectorizer": lambda a: _lazy(
        "research", "rankingvectorizer_main", a),
    # bin/ coverage + misc drivers
    "covmaker": lambda a: _lazy("research", "covmaker_main", a),
    "makequickbinvector": lambda a: _lazy(
        "research", "makequickbinvector_main", a),
    "matrixtocolumns": lambda a: _lazy(
        "research", "matrixtocolumns_main", a),
    "bloomfilterparser": lambda a: _lazy(
        "research", "bloomfilterparser_main", a),
    "processfrag": lambda a: _lazy("research", "processfrag_main", a),
    "postfilter": lambda a: _lazy("research", "postfilter_main", a),
    "reassemble": lambda a: _lazy("research", "reassemble_main", a),
    # launcher infra + log processing
    "calcmem": lambda a: _lazy("fileutils", "calcmem_main", a),
    "memdetect": lambda a: _lazy("fileutils", "calcmem_main", a),
    "javasetup": lambda a: _lazy("fileutils", "javasetup_main", a),
    "profile": lambda a: _lazy("fileutils", "profile_main", a),
    "fix_script_paths": lambda a: _lazy(
        "fileutils", "fix_script_paths_main", a),
    "addx": lambda a: _lazy("fileutils", "addx_main", a),
    "zz_rename_package": lambda a: _lazy(
        "fileutils", "zz_rename_package_main", a),
    "processspeed": lambda a: _lazy("fileutils", "processspeed_main", a),
    "webcheck": lambda a: _lazy("fileutils", "webcheck_main", a),
    "summarizecontam": lambda a: _lazy(
        "fileutils", "summarizecontam_main", a),
    "analyzesketchresults": lambda a: _lazy(
        "fileutils", "analyzesketchresults_main", a),
    # Illumina CBCL
    "cbcl2text": lambda a: _lazy("illuminatools", "cbcl2text_main", a),
    "bbcrisprfinder": lambda a: _lazy("crispr", "main", a),
}


def _splitsam_n(args, way: int):
    from .models.samutils import splitsam

    return splitsam(args, way=way)


def _lazy(module: str, fn: str, args, *extra):
    import importlib

    m = importlib.import_module(f".models.{module}", __package__)
    return getattr(m, fn)(args, *extra)


#: flag names that name INPUT files (never treated as outputs below)
_INPUT_KEYS = frozenset({
    "in", "in1", "in2", "ref", "extra", "sam", "invcf", "vcfin", "vcf0",
    "input", "literal", "adapters", "barcodes", "names", "tree", "table",
    "gi", "accession", "config", "net", "netfile", "model", "sketch_in",
})

#: output values that never collide (stream/sink sentinels)
_SINK_VALUES = frozenset({"stdout", "stderr", "null", "/dev/null", "-"})


def guard_output_files(argv: list[str]):
    """Universal output-collision pre-check, applied to EVERY tool before
    dispatch — the reference calls shared/Tools.testOutputFiles in every
    tool's setup (e.g. bbduk/BBDukS.java:185); centralizing it here gives
    all 315 launchers the contract at once. Checks: duplicate output
    paths, outputs shadowing inputs, and existing files unless
    overwrite=t (ow). Tools with richer local checks still run them."""
    import os

    pairs = []
    for tok in argv:
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        pairs.append((k.strip().lower().lstrip("-"), v.strip()))
    overwrite = True
    for k, v in pairs:
        if k in ("overwrite", "ow"):
            overwrite = v.lower() in ("t", "true", "1", "yes", "y", "")
    ins = set()
    outs = []
    for k, v in pairs:
        if not v or v.lower() in _SINK_VALUES or v.lower().startswith(
            "stdout."
        ):
            continue
        # boolean-valued out* flags (e.g. enable toggles) are not paths
        if v.lower() in ("t", "f", "true", "false"):
            continue
        if k in _INPUT_KEYS:
            for p in v.split(","):
                if p:
                    ins.add(os.path.abspath(p))
        elif k.startswith("out"):
            # demux-style patterned outputs (out=%.fq) expand per key and
            # cannot collide statically
            if "%" in v or "#" in v:
                continue
            for p in v.split(","):
                if p:
                    outs.append(p)
    seen = {}
    for p in outs:
        ap = os.path.abspath(p)
        if ap in seen:
            raise ValueError(f"Duplicate output file: {p}")
        seen[ap] = p
        if ap in ins:
            raise ValueError(f"Output file {p} is also an input")
        if os.path.exists(p) and not overwrite:
            raise ValueError(
                f"Output file {p} exists; use overwrite=t (ow) to replace"
            )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("bbtools_tpu — accelerator-native sequence analysis toolkit")
        print("usage: python -m bbtools_tpu <tool> key=value ...")
        print("tools:", ", ".join(sorted(set(TOOLS))))
        return 0
    tool = argv[0].lower().removesuffix(".sh")
    fn = TOOLS.get(tool)
    if fn is None:
        print(f"Unknown tool: {tool}", file=sys.stderr)
        print("tools:", ", ".join(sorted(set(TOOLS))), file=sys.stderr)
        return 2
    # multi-host: JAX_COORDINATOR/JAX_NUM_PROCESSES/JAX_PROCESS_ID env
    # joins this process into the cluster before any tool touches jax —
    # sharded tools (tpshards=/shards=) then span all hosts' devices
    # (SURVEY §5.8 design; tests/test_multichip.py 2-process proof)
    import os as _os

    if _os.environ.get("JAX_COORDINATOR"):
        from .parallel.distributed import initialize

        if initialize():
            import jax as _jax

            print(
                f"Joined jax.distributed cluster: process "
                f"{_jax.process_index()}/{_jax.process_count()}, "
                f"{_jax.device_count()} global devices",
                file=sys.stderr,
            )
    guard_output_files(argv[1:])
    fn(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
